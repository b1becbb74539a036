"""Live gossip ingest: dedup and pending rules in front of the batched
verify on the card, feeding the gossip_store.

After Core Lightning's gossipd/gossmap_manage.c (pending maps, dedup,
the channel_announcement checks) and BOLT #7's ratelimit and stale-update
rules.  Where gossipd calls ``check_signed_hash`` once a signature,
messages queue into one ``VerifyItems`` batch that is flushed through
``verify.verify_items`` on the card (K1 -> K2 -> K3 under the default
engine) when it reaches ``flush_size`` signatures or ``flush_ms`` of
latency budget; both widen with the backlog (``resilience/overload.py``).

Daemons push raw gossip messages with ``submit()``; the accepted messages
of a flush are appended to the store in one write and fsync'd, and only
then handed to ``on_accept``.  An exception in a flush goes to the flush
loop's restart supervision: it is counted and emitted, never turned into
a verdict.

Each message's ``gossip/submit`` span mints a correlation carrier that
rides its queue item into the flush: the ``gossip/flush`` span and every
bucket dispatch of the flush's ``verify_items`` (a supervised, flight-
recorded replay) carry the batch's carriers across the worker thread.
"""
from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

import numpy as np

from .. import device as D
from .. import obs
from ..obs import families as _families
from ..obs import journey as _journey
from ..resilience import deadline as _deadline
from ..resilience import overload as _overload
from ..utils import events, trace
from . import store as gstore
from . import verify as gverify
from . import wire

log = logging.getLogger("lightning_tpu_torch.gossip.ingest")

# bounded-queue watermarks, in signatures: the queue sheds by priority at
# the high watermark and transport backpressure releases below the low
INGEST_HIGH_WM = 4096
INGEST_LOW_WM = INGEST_HIGH_WM // 2
# bound of the pending maps (messages held for a missing channel)
PENDING_CAP = max(1024, INGEST_HIGH_WM)

_M_FLUSH_SECONDS = obs.histogram(
    "clntpu_gossip_flush_seconds",
    "End-to-end wall time of one ingest flush "
    "(build + device verify + apply + store append)")
_M_FLUSH_SIGS = obs.histogram(
    "clntpu_gossip_flush_sigs",
    "Signatures per ingest flush", buckets=obs.SIZE_BUCKETS)
_M_ACCEPTED = obs.counter(
    "clntpu_gossip_accepted_total", "Gossip messages accepted")
_M_DROPPED = obs.counter(
    "clntpu_gossip_dropped_total",
    "Gossip messages dropped/held before acceptance, by reason",
    labelnames=("reason",))
_M_QUEUE = obs.gauge(
    "clntpu_gossip_queue_sigs",
    "Signatures currently queued awaiting a verify flush")
_M_BACKLOG = _families.INGEST_BACKLOG
_M_FLUSH_ERRORS = _families.INGEST_FLUSH_ERRORS

# drop reasons
R_DUP = "duplicate"
R_STALE = "stale_timestamp"
R_BADSIG = "bad_signature"
R_NO_CHANNEL = "pending_no_channel"   # held, not dropped
R_NO_UTXO = "utxo_check_failed"
R_RATELIMIT = "ratelimited"
R_MALFORMED = "malformed"
R_FLUSH_ERROR = "flush_error"         # batch lost to a flush exception
R_SHED = "shed_overload"              # priority-shed at the watermark

# BOLT #7 suggests limiting spammy channel_updates: a burst, then one
# update an interval per (channel, direction)
RATELIMIT_BURST = 4
RATELIMIT_INTERVAL = 300.0


@dataclass
class _QItem:
    kind: int                  # wire msg type
    parsed: object
    raw: bytes
    source: object             # opaque peer handle (None = local/store)
    n_sigs: int
    # the carrier minted at submit (trace.new_corr): links the message's
    # submit span to the flush and dispatch spans that verify it
    corr: object = None
    # enqueue time (self.now() at admission): the journey verify hop's
    # queue-wait anchor
    t_enq: float = 0.0


def _journey_entity(kind: int, parsed) -> tuple[str, object]:
    """The journey entity a gossip message narrates: channel messages
    key on their scid, node announcements on the node id."""
    if kind == wire.MSG_NODE_ANNOUNCEMENT:
        return "node", parsed.node_id
    return "channel", int(parsed.short_channel_id)


def _shed_key(kind: int, parsed) -> dict:
    """Message identity recorded with every shed: the key to ask for it
    again."""
    if kind == wire.MSG_CHANNEL_ANNOUNCEMENT:
        return {"kind": "channel_announcement",
                "scid": int(parsed.short_channel_id)}
    if kind == wire.MSG_CHANNEL_UPDATE:
        return {"kind": "channel_update",
                "scid": int(parsed.short_channel_id),
                "direction": int(parsed.direction),
                "timestamp": int(parsed.timestamp)}
    return {"kind": "node_announcement",
            "node_id": parsed.node_id.hex(),
            "timestamp": int(parsed.timestamp)}


@dataclass
class IngestStats:
    accepted: int = 0
    dropped: dict = field(default_factory=dict)
    flushes: int = 0
    batched_sigs: int = 0
    max_batch: int = 0

    def drop(self, reason: str) -> None:
        self.dropped[reason] = self.dropped.get(reason, 0) + 1
        _M_DROPPED.labels(reason).inc()


class GossipIngest:
    """Dedup, pending, batched verify on `device` (the card unless
    device="cpu"), store append."""

    def __init__(self, store_path: str, *, utxo_check=None,
                 flush_size: int = 256, flush_ms: float = 2.0,
                 bucket: int = gverify.DEFAULT_BUCKET,
                 on_accept=None, on_shed=None, now=time.monotonic,
                 own_node_id: bytes | None = None,
                 high_wm: int | None = None, low_wm: int | None = None,
                 pending_cap: int | None = None,
                 deadline_s: float | None = None, device=None):
        self.device = D.resolve(device)
        self.writer = gstore.StoreWriter(store_path)
        self.utxo_check = utxo_check      # async (scid)->sat|None, or None
        self.flush_size = flush_size
        self.flush_ms = flush_ms
        self.bucket = bucket
        # own-node and own-channel traffic (keyed on own_node_id) sheds
        # last; an open "verify" breaker doubles the retry hint
        self.own_node_id = own_node_id
        self.pending_cap = PENDING_CAP if pending_cap is None \
            else pending_cap
        self.overload = _overload.controller(
            "ingest",
            high_wm if high_wm is not None else INGEST_HIGH_WM,
            low_wm if low_wm is not None else INGEST_LOW_WM,
            breaker_family="verify", now=now)
        # bound of one verify dispatch (None: none)
        self.deadline_s = deadline_s
        self.on_accept = on_accept        # callback(raw, source)
        # callback(kind, parsed, source) for every shed message: the
        # caller may ask its source for it again
        self.on_shed = on_shed
        self.now = now
        self.stats = IngestStats()

        # accepted-state tables (gossmap_manage's in-memory view)
        self.channels: dict[int, tuple[bytes, bytes]] = {}  # scid -> nodes
        self.updates: dict[tuple[int, int], int] = {}   # (scid,dir) -> ts
        self.nodes: dict[bytes, int] = {}               # node_id -> ts
        self._channeled_nodes: set[bytes] = set()
        self._accepted: list[_QItem] = []               # staged this flush
        # pending: messages that arrived before their channel
        self.pending_updates: dict[int, dict[int, _QItem]] = {}
        self.pending_nodes: dict[bytes, _QItem] = {}
        # ratelimit token state per (scid, direction)
        self._tokens: dict[tuple[int, int], tuple[float, float]] = {}

        self._queue: list[_QItem] = []
        self._queued_sigs = 0
        self._inflight_sigs = 0          # popped batch being verified
        self._pending_held = 0           # entries across both pending maps
        self._flush_due: float | None = None
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        self._flushing = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        self._wakeup.set()
        if self._task is not None:
            await self._task
        self.writer.close()

    # -- submission ---------------------------------------------------------

    async def wait_capacity(self, max_wait: float | None = None) -> float:
        """Transport-side backpressure: while the backlog is saturated,
        pause the calling read pump (bounded a message; every waiter is
        released once the backlog drains below the low watermark)."""
        return await self.overload.wait_capacity(max_wait)

    async def submit(self, raw: bytes, source=None) -> None:
        """Queue one raw gossip message for verification.  The submit
        span is the message's enqueue point: the carrier minted here
        rides the queue item into the flush."""
        with trace.span("gossip/submit"):
            await self._submit(raw, source)

    async def _submit(self, raw: bytes, source) -> None:
        try:
            parsed = wire.parse_gossip(raw)
        except Exception:
            self.stats.drop(R_MALFORMED)
            return
        if parsed is None:
            self.stats.drop(R_MALFORMED)
            return
        kind = wire.msg_type(raw)
        if not self._precheck(kind, parsed, raw, source):
            return
        # overload admission comes BEFORE the ratelimiter: a shed message
        # must not spend a token, or a replay of the non-shed subset
        # would see other token states and accept another set
        prio = self._priority(kind, parsed)
        n_sigs = 4 if kind == wire.MSG_CHANNEL_ANNOUNCEMENT else 1
        if not self.overload.admit(prio, n_sigs):
            self.stats.drop(R_SHED)
            self._shed(prio, "queue_full", kind, parsed, source)
            jk, jkey = _journey_entity(kind, parsed)
            _journey.hop("shed", jk, jkey, outcome=R_SHED,
                         reason="queue_full")
            return
        if kind == wire.MSG_CHANNEL_UPDATE and not self._ratelimit_ok(
                (parsed.short_channel_id, parsed.direction)):
            self.stats.drop(R_RATELIMIT)
            jk, jkey = _journey_entity(kind, parsed)
            _journey.hop("drop", jk, jkey, outcome=R_RATELIMIT)
            return
        it = _QItem(kind, parsed, raw, source, n_sigs,
                    corr=trace.new_corr(), t_enq=self.now())
        self._queue.append(it)
        self._queued_sigs += n_sigs
        jk, jkey = _journey_entity(kind, parsed)
        _journey.hop("admit", jk, jkey, outcome="ok",
                     corr_id=it.corr.corr_id, queued_sigs=self._queued_sigs)
        self._note_backlog()
        if self._flush_due is None:
            # the latency budget stretches as pressure rises
            self._flush_due = self.now() + self.overload.window_s(
                self.flush_ms)
            # the loop may be parked on an indefinite wait: rearm it
            self._wakeup.set()
        if self._queued_sigs >= self._flush_threshold():
            self._wakeup.set()

    def _shed(self, prio: int, reason: str, kind: int, parsed,
              source) -> None:
        """Record one shed message with the overload controller and hand
        it to ``on_shed``."""
        self.overload.shed(prio, reason, **_shed_key(kind, parsed))
        if self.on_shed is not None:
            self.on_shed(kind, parsed, source)

    def _flush_threshold(self) -> int:
        """flush_size when calm, widening toward flush_size *
        overload.FLUSH_WIDEN as the backlog climbs."""
        return self.overload.flush_target(self.flush_size)

    def _note_backlog(self) -> None:
        _M_QUEUE.set(self._queued_sigs)
        _M_BACKLOG.set(self._queued_sigs + self._inflight_sigs)
        self.overload.update(self._queued_sigs, self._inflight_sigs)

    def _priority(self, kind: int, parsed) -> int:
        """Own-node and own-channel traffic sheds last, fresh third-party
        channel data next, node announcements first."""
        own = self.own_node_id
        if kind == wire.MSG_CHANNEL_ANNOUNCEMENT:
            if own is not None and own in (parsed.node_id_1,
                                           parsed.node_id_2):
                return _overload.PRIO_OWN
            return _overload.PRIO_FRESH
        if kind == wire.MSG_CHANNEL_UPDATE:
            if own is not None and own in self.channels.get(
                    parsed.short_channel_id, ()):
                return _overload.PRIO_OWN
            return _overload.PRIO_FRESH
        if own is not None and parsed.node_id == own:
            return _overload.PRIO_OWN
        return _overload.PRIO_BULK

    def _precheck(self, kind: int, parsed, raw: bytes, source) -> bool:
        """Host-side dedup before paying for signature checks (gossipd's
        order).  The stateful gates (overload admission, ratelimit)
        follow in submit()."""
        if kind == wire.MSG_CHANNEL_ANNOUNCEMENT:
            if parsed.short_channel_id in self.channels:
                self.stats.drop(R_DUP)
                _journey.hop("drop", "channel",
                             parsed.short_channel_id, outcome=R_DUP)
                return False
        elif kind == wire.MSG_CHANNEL_UPDATE:
            key = (parsed.short_channel_id, parsed.direction)
            if self.updates.get(key, -1) >= parsed.timestamp:
                self.stats.drop(R_STALE)
                _journey.hop("drop", "channel",
                             parsed.short_channel_id, outcome=R_STALE)
                return False
            if parsed.short_channel_id not in self.channels:
                # the signer is node[direction] of a channel we don't
                # know yet: hold the latest per direction (gossmap_manage's
                # pending_cupdates), resubmitted when the channel lands.
                # Past the cap a NEW key sheds instead of growing the map.
                held = self.pending_updates.get(parsed.short_channel_id)
                prev = held.get(parsed.direction) if held else None
                if prev is None:
                    if self._pending_held >= self.pending_cap:
                        self.stats.drop(R_SHED)
                        self._shed(self._priority(kind, parsed),
                                   "pending_cap", kind, parsed, source)
                        _journey.hop("shed", "channel",
                                     parsed.short_channel_id,
                                     outcome=R_SHED, reason="pending_cap")
                        return False
                    self.pending_updates.setdefault(
                        parsed.short_channel_id, {})[parsed.direction] = \
                        _QItem(kind, parsed, raw, source, 1)
                    self._pending_held += 1
                elif prev.parsed.timestamp < parsed.timestamp:
                    held[parsed.direction] = _QItem(
                        kind, parsed, raw, source, 1)
                self.stats.drop(R_NO_CHANNEL)
                return False
        elif kind == wire.MSG_NODE_ANNOUNCEMENT:
            if self.nodes.get(parsed.node_id, -1) >= parsed.timestamp:
                self.stats.drop(R_STALE)
                _journey.hop("drop", "node", parsed.node_id,
                             outcome=R_STALE)
                return False
        else:
            self.stats.drop(R_MALFORMED)
            return False
        return True

    def _ratelimit_ok(self, key) -> bool:
        tokens, last = self._tokens.get(key, (float(RATELIMIT_BURST), 0.0))
        t = self.now()
        tokens = min(RATELIMIT_BURST,
                     tokens + (t - last) / RATELIMIT_INTERVAL)
        if tokens < 1.0:
            self._tokens[key] = (tokens, t)
            return False
        self._tokens[key] = (tokens - 1.0, t)
        return True

    # -- the flush loop -----------------------------------------------------

    async def _run(self) -> None:
        """Supervised flush loop: an exception escaping a flush is
        emitted on the events bus (topic ``ingest_flush_error``) and the
        loop restarts after a capped exponential backoff."""
        backoff = _deadline.RestartBackoff()
        while not self._closed:
            try:
                await self._step()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                delay = backoff.next()
                _M_FLUSH_ERRORS.inc()
                _deadline.note_restart("ingest_flush", e, delay)
                events.emit("ingest_flush_error",
                            {"error": repr(e),
                             "restart_delay_s": round(delay, 3)})
                await asyncio.sleep(delay)
            else:
                backoff.reset()
        if self._queue:
            try:
                await self.flush()
            except Exception as e:  # shutting down: surface, don't retry
                _M_FLUSH_ERRORS.inc()
                events.emit("ingest_flush_error",
                            {"error": repr(e), "restart_delay_s": 0.0})
                log.exception("final ingest flush failed on close")

    async def _step(self) -> None:
        """One loop iteration: wait for the deadline or the size trigger,
        flush if due."""
        if self._flush_due is None:
            await self._wakeup.wait()
            self._wakeup.clear()
            return
        timeout = self._flush_due - self.now()
        if timeout > 0 and self._queued_sigs < self._flush_threshold():
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wakeup.clear()
            return  # re-evaluate: deadline, size, or shutdown
        if self._queue:
            await self.flush()

    async def drain(self) -> None:
        """Wait until every submitted message has been flushed and
        applied (pending resubmissions those flushes caused included)."""
        while self._queue or self._flushing:
            await asyncio.sleep(0.005)

    async def flush(self) -> None:
        """Verify everything queued in one batch on the card, then apply
        the accepted messages in arrival order."""
        batch, self._queue = self._queue, []
        n_sigs = self._queued_sigs
        self._queued_sigs = 0
        self._flush_due = None
        self._inflight_sigs = n_sigs
        self._note_backlog()
        if not batch:
            self._inflight_sigs = 0
            return
        self._flushing = True
        t0 = time.perf_counter()
        try:
            await self._flush_batch(batch)
        except BaseException:
            # the batch was already popped: count the loss (application
            # may have partly happened)
            for _ in batch:
                self.stats.drop(R_FLUSH_ERROR)
            raise
        finally:
            self._flushing = False
            dt = time.perf_counter() - t0
            _M_FLUSH_SECONDS.observe(dt)
            self._inflight_sigs = 0
            # drain rate for the retry hint, then the post-flush backlog
            # (wakes backpressure waiters below the low watermark)
            self.overload.note_drain(n_sigs, dt)
            self._note_backlog()

    async def _flush_batch(self, batch: list[_QItem]) -> None:
        corrs = [it.corr for it in batch if it.corr is not None]
        items = self._build_items(batch)
        self.stats.flushes += 1
        self.stats.batched_sigs += len(items)
        self.stats.max_batch = max(self.stats.max_batch, len(items))
        _M_FLUSH_SIGS.observe(len(items))
        # per-item provenance: with journeys on, dispatch_map receives,
        # a signature, the dispatch_id of the flight record whose bucket
        # verified it, and the batch-side queue wait sums (flush start -
        # enqueue) over EVERY queued item
        jw = _journey.enabled()
        dmap = np.full(len(items), -1, np.int64) if jw else None
        t_flush0 = self.now()
        if jw:
            _journey.note_batch_wait(
                "verify", sum(max(0.0, t_flush0 - it.t_enq)
                              for it in batch if it.t_enq))
        t_verify0 = time.perf_counter()
        # the deadline bounds only the (pure) verify dispatch, so a blown
        # deadline cannot split the apply and the store append below; the
        # carriers cross the worker-thread hop explicitly
        with trace.span("gossip/flush", corr=corrs, sigs=len(items)):
            ok = await _deadline.guard(
                asyncio.to_thread(gverify.verify_items, items, self.bucket,
                                  device=self.device, corr=corrs,
                                  dispatch_map=dmap),
                self.deadline_s, "ingest", "flush")
        verify_dt = time.perf_counter() - t_verify0
        # per-signature verdicts to per-message (4 for an announcement)
        sig_ok: list[bool] = []
        first_sig: list[int] = []
        pos = 0
        for it in batch:
            sig_ok.append(bool(ok[pos:pos + it.n_sigs].all()))
            first_sig.append(pos)
            pos += it.n_sigs
        if jw:
            for it, good, fs in zip(batch, sig_ok, first_sig):
                jk, jkey = _journey_entity(it.kind, it.parsed)
                did = int(dmap[fs]) if fs < len(dmap) and dmap[fs] >= 0 \
                    else None
                _journey.hop(
                    "verify", jk, jkey, outcome="ok" if good else R_BADSIG,
                    wait_s=max(0.0, t_flush0 - it.t_enq) if it.t_enq
                    else 0.0,
                    service_s=verify_dt, dispatch_id=did,
                    corr_id=it.corr.corr_id if it.corr is not None
                    else None)
        self._accepted = []
        for it, good in zip(batch, sig_ok):
            if not good:
                self.stats.drop(R_BADSIG)
                if jw:
                    jk, jkey = _journey_entity(it.kind, it.parsed)
                    _journey.hop("drop", jk, jkey, outcome=R_BADSIG)
                continue
            await self._apply(it)
        if self._accepted:
            # write-ahead: ONE append_many and fsync for the whole batch,
            # then stream: nothing reaches peers before it is durable
            t_store0 = time.perf_counter()
            self.writer.append_many(
                [it.raw for it in self._accepted],
                [getattr(it.parsed, "timestamp", 0)
                 for it in self._accepted], sync=True)
            store_dt = time.perf_counter() - t_store0
            if jw:
                for it in self._accepted:
                    jk, jkey = _journey_entity(it.kind, it.parsed)
                    _journey.hop(
                        "store", jk, jkey, outcome="ok", service_s=store_dt,
                        corr_id=it.corr.corr_id if it.corr is not None
                        else None)
            self.stats.accepted += len(self._accepted)
            _M_ACCEPTED.inc(len(self._accepted))
            if self.on_accept is not None:
                for it in self._accepted:
                    self.on_accept(it.raw, it.source)
            self._accepted = []

    async def _apply(self, it: _QItem) -> None:
        """Acceptance after the signatures: state tables, then staging for
        the store."""
        kind, p = it.kind, it.parsed
        if kind == wire.MSG_CHANNEL_ANNOUNCEMENT:
            scid = p.short_channel_id
            if scid in self.channels:       # raced within one batch
                self.stats.drop(R_DUP)
                _journey.hop("drop", "channel", scid, outcome=R_DUP)
                return
            if self.utxo_check is not None:
                sat = await self.utxo_check(scid)
                if sat is None:
                    self.stats.drop(R_NO_UTXO)
                    _journey.hop("drop", "channel", scid,
                                 outcome=R_NO_UTXO)
                    return
            self.channels[scid] = (p.node_id_1, p.node_id_2)
            self._channeled_nodes.update((p.node_id_1, p.node_id_2))
            self._accepted.append(it)
            # resubmit the pendings this channel satisfies
            drained = self.pending_updates.pop(scid, {})
            self._pending_held -= len(drained)
            for q in drained.values():
                await self.submit(q.raw, q.source)
            for nid in (p.node_id_1, p.node_id_2):
                q = self.pending_nodes.pop(nid, None)
                if q is not None:
                    self._pending_held -= 1
                    await self.submit(q.raw, q.source)
        elif kind == wire.MSG_CHANNEL_UPDATE:
            scid, d = p.short_channel_id, p.direction
            if self.updates.get((scid, d), -1) >= p.timestamp:
                self.stats.drop(R_STALE)   # raced within one batch
                _journey.hop("drop", "channel", scid, outcome=R_STALE)
                return
            self.updates[(scid, d)] = p.timestamp
            self._accepted.append(it)
        elif kind == wire.MSG_NODE_ANNOUNCEMENT:
            nid = p.node_id
            if nid not in self._channeled_nodes:
                prev = self.pending_nodes.get(nid)
                if prev is None:
                    # the held map is bounded like pending_updates; own
                    # node announcements are exempt (one node at most)
                    prio = self._priority(kind, p)
                    if prio != _overload.PRIO_OWN and \
                            self._pending_held >= self.pending_cap:
                        self.stats.drop(R_SHED)
                        self._shed(prio, "pending_cap", kind, p, it.source)
                        return
                    self.pending_nodes[nid] = it
                    self._pending_held += 1
                elif prev.parsed.timestamp < p.timestamp:
                    self.pending_nodes[nid] = it
                self.stats.drop(R_NO_CHANNEL)
                return
            if self.nodes.get(nid, -1) >= p.timestamp:
                self.stats.drop(R_STALE)
                _journey.hop("drop", "node", nid, outcome=R_STALE)
                return
            self.nodes[nid] = p.timestamp
            self._accepted.append(it)

    def _build_items(self, batch: list[_QItem]) -> gverify.VerifyItems:
        """The batch as one VerifyItems workload; a channel_update is
        checked against its direction's endpoint of the accepted channel
        (_precheck guarantees the channel is known by now), so identity
        and signature are one check."""
        return gverify.message_items(
            [it.parsed for it in batch],
            lambda scid, d: self.channels[scid][d])
