"""Device-batched pathfinding: a batched backward Bellman-Ford sweep over
RoutePlanes on the card (kernel R1, routing/csrc/route_sweep.cu), plus
the micro-batching RouteService front-end.

The host dijkstra (routing/dijkstra.py) solves one query at a time with
a heapq; here Q concurrent queries become one kernel launch.

Sweep: ``max_hops`` Jacobi relaxation sweeps.  Each sweep reads the
previous sweep's (cost, amount, delay) labels at every edge's RECEIVING
node, prices the edge with dijkstra's exact integer cost model
(compounding msat fees + CLN risk cost), and folds candidates per
FORWARDING node with two minimums (cost, then lowest edge index among
cost ties).  After k sweeps a node's label is the cheapest <= k-hop path
to the destination, dijkstra's settled label whenever the hop cap does
not bind (LN paths are ~5 hops against a cap of 20).

Tie-break rule: among equal-cost candidate edges for a node within one
sweep, the LOWEST edge index in the destination-keyed CSR wins; an
existing label is only replaced by a STRICTLY cheaper one.  Total cost
does not depend on it; the chosen hops may differ from dijkstra's when
distinct paths price identically.

Exactness: all msat math is int64.  Per-edge overflow guards bound every
product below 2^61; a query whose relaxation would pass them raises an
overflow flag and is answered by the host (Python ints).  Every
returned route re-validates on the host with exact ints (hop cap, HTLC
windows, total cost against the kernel's label) and goes to the host on
any mismatch, so a device "ok" is always a valid route priced by
dijkstra's exact cost model.  When the 20-hop cap BINDS, dijkstra's hop
limit is a search prune while the sweep solves the <= 20-edge problem
exactly: the device can then return a valid route where the host
reports NoRoute.

Host answers are part of the exactness contract and nothing else: a
query the sweep cannot express (amount or riskfactor past its cap, a
max_hops other than the sweep count) or whose answer could not be
proven (overflow, reconstruction mismatch) is answered by dijkstra, and
counted by reason in ``clntpu_route_fallback_total``.  Every flush of
the service goes to the card, however few queries it holds.

Supervision (``FlushService``, shared with mcf_device.McfService): each
flush is one flight-recorded dispatch of its family, in a
``<family>/flush`` span flow-linked to the queries' ``<family>/enqueue``
spans.  The family's breaker is asked only when a dispatch will follow;
the ``dispatch`` fault seam fires on the loop inside the deadline
(``deadline_s``, off by default), so an injected hang blows it; the
device share's lanes, occupancy and staged bytes go on the record, and
the ``clntpu_<family>_*`` families count the flush.  No host answer
follows a failed dispatch: an open breaker, a blown deadline or a
dispatch error fails the flush's device queries with ``BreakerOpen``
(with ``retry_in_s``), ``DeadlineExceeded`` or the error.  The
record's outcome, against the JAX package's for the same flush:

    JAX package                          port
    ok                                   ok
    host (after a device error)          error
    host_breaker                         breaker
    deadline                             deadline
    host (a flush with no device share)  host
"""
from __future__ import annotations

import asyncio
import logging
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as D
from ..obs import attribution as _attr
from ..obs import families as _families
from ..obs import flight as _flight
from ..obs import journey as _journey
from ..resilience import breaker as _breaker
from ..resilience import deadline as _deadline
from ..resilience import faultinject as _fault
from ..resilience import overload as _overload
from ..utils import events, trace
from . import dijkstra as DJ
from . import hopper_route as HR
from .dijkstra import NoRoute, RouteHop
from .planes import RoutePlanes

log = logging.getLogger("lightning_tpu_torch.routing.device")

DEFAULT_MAX_HOPS = 20
# label sentinel: far above any real path cost, far below int64 overflow
# even after adding one more edge's fee+risk
INF_COST = HR.INF_COST

ROUTE_BATCH = 64            # device query bucket
ROUTE_FLUSH_MS = 2.0        # flush latency budget
ROUTE_MAX_AMOUNT_MSAT = 1 << 48
# admission-control high watermark, in queued QUERIES (the low one is
# half of it): past it getroute rejects retryably (Overloaded with a
# retry-after hint) instead of queueing without bound
ROUTE_HIGH_WM = 256
# riskfactor joins cd (<= 2^16) in an int64 product INSIDE the overflow
# guard itself: a huge rf would wrap cd * rf and disarm the guard, so
# larger values go to the host's Python ints
ROUTE_MAX_RISKFACTOR = 1_000_000

# host-answer reasons
R_AMOUNT_CAP = "amount_cap"
R_RISKFACTOR_CAP = "riskfactor_cap"
R_MAX_HOPS = "max_hops"
R_OVERFLOW = "overflow"
R_RECONSTRUCT = "reconstruct"

_PLANE_ORDER = ("edge_src", "edge_dst", "edge_base", "edge_ppm",
                "edge_cltv", "edge_hmin", "edge_hmax")
# parameter planes a channel_update can change (patched on the device);
# src/dst are topology and only ever upload whole
_PARAM_PLANES = ("edge_base", "edge_ppm", "edge_cltv", "edge_hmin",
                 "edge_hmax")


def _device_plane_args(planes: RoutePlanes) -> tuple:
    """Upload (once per planes revision) the planes to ``planes.device``
    and return ``(operands, staged_bytes)``: the planes, and the host
    bytes this call staged (0 when every plane was carried over).  R1's
    in-edge offsets sit beside them in ``planes.dev["in_off"]``.  A
    param-refresh revision arrives with the topology uploads carried
    over, so only the missing planes copy; an incremental revision
    (``patch_idx`` set by with_patched_params) scatters JUST the touched
    lanes.  The scatter is ``index_copy``, out of place, as the JAX
    package's ``.at[].set``: the predecessor revision's tensors stay as
    they were for a solve still reading them."""
    dev = planes.device
    staged = 0
    patch = planes.patch_idx
    if patch is not None and len(patch):
        idx = torch.as_tensor(patch, device=dev)
        staged += idx.nbytes
        for name in _PARAM_PLANES:
            if name in planes.dev:
                vals = torch.as_tensor(getattr(planes, name)[patch],
                                       device=dev)
                staged += vals.nbytes
                planes.dev[name] = planes.dev[name].index_copy(0, idx, vals)
    planes.patch_idx = None
    for name in (*_PLANE_ORDER, "in_off"):
        if name not in planes.dev:
            host = getattr(planes, name)
            planes.dev[name] = torch.as_tensor(host, device=dev)
            staged += host.nbytes
    return tuple(planes.dev[n] for n in _PLANE_ORDER), staged


# ---------------------------------------------------------------------------
# Batched solve + host-exact route reconstruction


@dataclass
class RouteQuery:
    """One getroute request (same semantics as dijkstra.getroute)."""

    source: bytes
    destination: bytes
    amount_msat: int
    final_cltv: int = 18
    riskfactor: int = DJ.DEFAULT_RISKFACTOR
    max_hops: int = DEFAULT_MAX_HOPS
    excluded_scids: set | None = None
    # (solve_batch always returns the payer-side (amount, delay) pair;
    # getroute's with_source only shapes ITS return value)
    future: object = None
    # the correlation carrier minted in the route/enqueue span
    corr: object = None


def _reconstruct(planes: RoutePlanes, via: np.ndarray, src: int, dst: int,
                 amount_msat: int, final_cltv: int, riskfactor: int,
                 dist_src: int, max_hops: int):
    """Walk the predecessor edges src -> dst, then price the path
    backward with exact Python ints: the amounts and delays are
    bit-identical to what dijkstra.py labels along the same hops.

    The walk RE-VALIDATES what the kernel checked against its in-sweep
    labels: a Jacobi label can survive pointing at a downstream chain
    that a later sweep rewrote, so the final chain may be longer than
    the sweep count, carry amounts outside an edge's HTLC window, or
    price differently than dist[src].  Any mismatch raises, and the
    caller sends the query to the host solver."""
    g = planes.g
    edges = []
    u = src
    while u != dst:
        e = int(via[u])
        # >= : dijkstra's hop cap is a hard contract
        if e < 0 or len(edges) >= max_hops:
            raise RuntimeError("predecessor walk diverged")
        edges.append(e)
        u = int(planes.edge_dst[e])
    amount, delay = amount_msat, final_cltv
    cost = 0
    amounts: list[tuple[int, int]] = []   # (amount, delay) at edge's dst
    for e in reversed(edges):
        amounts.append((amount, delay))
        if amount < int(planes.edge_hmin[e]):
            raise RuntimeError("reconstructed amount under htlc_min")
        hmax = int(planes.edge_hmax[e])
        if hmax and amount > hmax:
            raise RuntimeError("reconstructed amount over htlc_max")
        fee = DJ.hop_fee_msat(int(planes.edge_base[e]),
                              int(planes.edge_ppm[e]), amount)
        cost += fee + DJ._risk_msat(amount, int(planes.edge_cltv[e]),
                                    riskfactor)
        amount += fee
        delay += int(planes.edge_cltv[e])
    if cost != dist_src:
        raise RuntimeError("reconstructed cost disagrees with label")
    amounts.reverse()
    route = [
        RouteHop(
            node_id=bytes(g.node_ids[int(planes.edge_dst[e])]),
            scid=int(g.scids[int(planes.edge_chan[e])]),
            direction=int(planes.edge_dir[e]),
            amount_msat=amt, delay=dly,
        )
        for e, (amt, dly) in zip(edges, amounts)
    ]
    return route, (amount, delay)


def solve_batch(planes: RoutePlanes, queries: list[RouteQuery],
                batch: int = ROUTE_BATCH,
                io_acct: dict | None = None) -> list[tuple]:
    """Solve every query in ceil(Q / batch) sweeps on ``planes.device``
    (R1 on the card, its plain version on the CPU).

    Returns one tuple per query:
      ("ok", route, (src_amount, src_delay))  reachable, exact
      ("noroute", message)                    provably unreachable
      ("fallback", reason)                    the host answers instead
      ("error", exc)                          the query's own error

    The host<->device bytes this call staged are counted in
    clntpu_transfer_bytes_total{family="route"} and, when ``io_acct`` is
    given, added to its ``h2d_bytes`` / ``d2h_bytes``.
    """
    g = planes.g
    dev = planes.device
    out: list[tuple] = [None] * len(queries)
    idx_cache: dict[bytes, int] = {}

    def node_idx(nid: bytes) -> int:
        i = idx_cache.get(nid)
        if i is None:
            i = idx_cache[nid] = g.node_index(nid)
        return i

    plane_args, h2d = _device_plane_args(planes)
    d2h = 0
    # the sweep's shape key: node pad, edge pad, batch width, sweeps
    _attr.note_program("route", (planes.n_pad, planes.e_pad, batch,
                                 DEFAULT_MAX_HOPS))
    for start in range(0, len(queries), batch):
        chunk = queries[start:start + batch]
        ok_mat = np.zeros((batch, planes.e_pad), bool)
        src = np.zeros(batch, np.int32)
        dst = np.zeros(batch, np.int32)
        amount = np.ones(batch, np.int64)
        cltv = np.zeros(batch, np.int64)
        rf = np.ones(batch, np.int64)
        for i, q in enumerate(chunk):
            try:
                src[i] = node_idx(q.source)
                dst[i] = node_idx(q.destination)
            except KeyError as e:
                # unknown node: this query's error, not the batch's; its
                # lanes stay masked-off padding
                out[start + i] = ("error", e)
                continue
            if src[i] == dst[i]:
                # dijkstra raises NoRoute here; a dst-initialized label
                # would otherwise read as a zero-cost empty route
                out[start + i] = ("noroute", "source is destination")
                continue
            # values outside [0, cap] would wrap the sweep's own int64
            # guard products, and the sweep count is fixed for the
            # batch, so a per-query hop cap cannot be honoured
            if not 0 <= q.amount_msat <= ROUTE_MAX_AMOUNT_MSAT:
                out[start + i] = ("fallback", R_AMOUNT_CAP)
                continue
            if not 0 <= q.riskfactor <= ROUTE_MAX_RISKFACTOR:
                out[start + i] = ("fallback", R_RISKFACTOR_CAP)
                continue
            if q.max_hops != DEFAULT_MAX_HOPS:
                out[start + i] = ("fallback", R_MAX_HOPS)
                continue
            amount[i] = q.amount_msat
            cltv[i] = q.final_cltv
            rf[i] = q.riskfactor
            ok_mat[i] = planes.edge_ok_mask(q.excluded_scids)
        lanes = (ok_mat, src, dst, amount, cltv, rf)
        h2d += sum(a.nbytes for a in lanes)
        dist_src, via, ovf = (t.cpu().numpy() for t in HR.route_sweep(
            *plane_args, *(torch.as_tensor(a, device=dev) for a in lanes),
            planes.n_pad, DEFAULT_MAX_HOPS, in_off=planes.dev["in_off"]))
        d2h += dist_src.nbytes + via.nbytes + ovf.nbytes
        for i, q in enumerate(chunk):
            if out[start + i] is not None:
                continue       # resolved above
            if ovf[i]:
                # int64 headroom exceeded somewhere reachable: the host's
                # Python ints own this query (exactness over speed)
                out[start + i] = ("fallback", R_OVERFLOW)
            elif dist_src[i] >= INF_COST:
                out[start + i] = ("noroute", _noroute_msg(q))
            else:
                try:
                    route, src_info = _reconstruct(
                        planes, via[i], int(src[i]), int(dst[i]),
                        q.amount_msat, q.final_cltv, q.riskfactor,
                        int(dist_src[i]), DEFAULT_MAX_HOPS)
                    out[start + i] = ("ok", route, src_info)
                except RuntimeError as e:
                    log.warning("route reconstruction diverged (%s); "
                                "the host answers", e)
                    out[start + i] = ("fallback", R_RECONSTRUCT)
    _families.TRANSFER_BYTES.labels("route", "h2d").inc(h2d)
    _families.TRANSFER_BYTES.labels("route", "d2h").inc(d2h)
    if io_acct is not None:
        io_acct["h2d_bytes"] = io_acct.get("h2d_bytes", 0) + h2d
        io_acct["d2h_bytes"] = io_acct.get("d2h_bytes", 0) + d2h
    return out




def _noroute_msg(q: RouteQuery) -> str:
    return DJ.noroute_msg(q.source, q.destination, q.amount_msat)


def route_cost_msat(g, route: list[RouteHop], riskfactor: int) -> int:
    """Total dijkstra-model cost (fees + risk) of a hop list: the parity
    currency between the host and device solvers."""
    cost = 0
    for h in route:
        c = g.channel_index(h.scid)
        d = h.direction
        fee = DJ.hop_fee_msat(int(g.fee_base_msat[d, c]),
                              int(g.fee_ppm[d, c]), h.amount_msat)
        risk = DJ._risk_msat(h.amount_msat, int(g.cltv_delta[d, c]),
                             riskfactor)
        cost += fee + risk
    return cost


# ---------------------------------------------------------------------------
# The micro-batching front-end

# the routing services alive in this process (the incident recorder's
# knob file lists their arguments)
_LIVE: "weakref.WeakSet[FlushService]" = weakref.WeakSet()


def live_services() -> list:
    return list(_LIVE)


class FlushService:
    """The micro-batching flush loop the routing services share (the
    gossip ingest's shape): queries queue until the flush window closes
    or a batch is full, then one supervised flush answers them all.

    A subclass names its ``FAMILY`` (the breaker, flight records, spans,
    overload controller and ``<family>_flush_error`` events topic), its
    defaults and instruments (``M``: the family's ``clntpu_<family>_*``
    metrics), and implements ``_screen`` (which queries the host answers
    by the exactness contract), ``_solve`` (the batched dispatch, on the
    loop; it awaits ``_dispatch`` for each worker round) and
    ``_host_solve`` / ``_resolve``.

    ``deadline_s`` bounds each dispatch round (None: no bound)."""

    FAMILY = ""
    FLUSH_MS = 0.0
    BATCH = 0
    HIGH_WM = 0
    M: dict = {}
    # the journey stage whose batch wait the flush adds up (None: none)
    JOURNEY_STAGE: str | None = None

    def __init__(self, get_map, *, flush_ms: float | None = None,
                 batch: int | None = None, device=None,
                 now=time.monotonic, high_wm: int | None = None,
                 deadline_s: float | None = None):
        self.get_map = get_map          # () -> Gossmap | None
        self.device = D.resolve(device)
        self.flush_ms = self.FLUSH_MS if flush_ms is None else flush_ms
        self.batch = batch or self.BATCH
        self.deadline_s = deadline_s
        high = self.HIGH_WM if high_wm is None else high_wm
        self.overload = _overload.controller(
            self.FAMILY, high, high // 2, breaker_family=self.FAMILY,
            now=now)
        self.now = now
        self._planes = None             # the planes of the last dispatch
        self._queue: list = []
        self._inflight = 0               # queries inside a running flush
        self._flush_due: float | None = None
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        # (t_flush0, t_svc0, flight record) of the flush being resolved
        # (flushes are serialized on the loop, so one slot suffices)
        self._flush_ctx: tuple | None = None
        _LIVE.add(self)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        self._wakeup.set()
        if self._task is not None:
            await self._task

    # -- submission -------------------------------------------------------

    def _admit(self) -> asyncio.Future:
        """The future of one new query, or a raise: the service is not
        running, or (admission control) past the high watermark the
        query is REJECTED retryably instead of joining an unbounded
        queue."""
        if self._closed or self._task is None or self._task.done():
            raise RuntimeError(f"{self.FAMILY} service not running")
        if not self.overload.admit(_overload.PRIO_QUERY):
            self.overload.shed(_overload.PRIO_QUERY, "admission")
            raise self.overload.overloaded()
        return asyncio.get_running_loop().create_future()

    def _enqueue(self, q) -> None:
        self._queue.append(q)
        self._note_backlog()
        if self._flush_due is None:
            # adaptive flush window: the latency budget stretches as
            # pressure rises (throughput over latency under load)
            self._flush_due = self.now() + self.overload.window_s(
                self.flush_ms)
            self._wakeup.set()
        if len(self._queue) >= self._flush_threshold():
            self._wakeup.set()

    def _flush_threshold(self) -> int:
        """Adaptive size trigger: `batch` when calm, widening under
        pressure so one flush serves more queries."""
        return self.overload.flush_target(self.batch)

    def _note_backlog(self) -> None:
        self.M["queue"].set(len(self._queue))
        self.overload.update(len(self._queue), self._inflight)

    # -- the flush loop ---------------------------------------------------

    async def _run(self) -> None:
        """Supervised flush loop: an exception escaping a flush (its
        queries already failed with it) is counted and emitted on the
        events bus (topic ``<family>_flush_error``), and the loop
        restarts after a capped exponential backoff, queued queries
        intact."""
        topic = f"{self.FAMILY}_flush_error"
        try:
            backoff = _deadline.RestartBackoff()
            while not self._closed:
                try:
                    await self._step()
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    delay = backoff.next()
                    _deadline.note_restart(f"{self.FAMILY}_flush", e, delay)
                    events.emit(topic, {"error": repr(e),
                                        "restart_delay_s": round(delay, 3)})
                    await asyncio.sleep(delay)
                else:
                    backoff.reset()
            if self._queue:
                try:
                    await self.flush()
                except Exception as e:   # shutting down: surfaced
                    events.emit(topic, {"error": repr(e),
                                        "restart_delay_s": 0.0})
        finally:
            # cancellation teardown: strand no queued caller
            batch, self._queue = self._queue, []
            for q in batch:
                if not q.future.done():
                    q.future.set_exception(
                        RuntimeError(f"{self.FAMILY} service stopped"))

    async def _step(self) -> None:
        """One flush-loop iteration."""
        if self._flush_due is None:
            await self._wakeup.wait()
            self._wakeup.clear()
            return
        timeout = self._flush_due - self.now()
        if timeout > 0 and len(self._queue) < self._flush_threshold():
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wakeup.clear()
            return
        if self._queue:
            await self.flush()

    async def flush(self) -> None:
        """Answer everything queued: one supervised, batched dispatch on
        the card, the host answers of the exactness contract on the
        loop.  A failed dispatch fails its device queries (see the
        module docstring); an exception outside the dispatch fails the
        flush's unanswered queries with it and propagates."""
        batch, self._queue = self._queue, []
        self._flush_due = None
        self._inflight = len(batch)
        self._note_backlog()
        if not batch:
            self._inflight = 0
            return
        t0 = time.perf_counter()
        try:
            await self._flush_batch(batch)
        except Exception as e:
            log.exception("%s flush failed", self.FAMILY)
            for q in batch:
                if not q.future.done():
                    self.M["queries"].labels("host", "error").inc()
                    q.future.set_exception(e)
            raise
        finally:
            dt = time.perf_counter() - t0
            self.M["flush_seconds"].observe(dt)
            self._inflight = 0
            self.overload.note_drain(len(batch), dt)
            self._note_backlog()

    async def _flush_batch(self, batch: list) -> None:
        """One flight-recorded dispatch a flush: the record carries the
        queries' corr ids and the flush's outcome, and the
        ``<family>/flush`` span flow-links back to each enqueue span."""
        corrs = trace.as_carriers(q.corr for q in batch)
        brk = _breaker.get(self.FAMILY)
        t_flush0 = self.now()
        if self.JOURNEY_STAGE is not None and _journey.enabled():
            # batch-side queue wait over EVERY query: what the sampled
            # journeys' waits add up to
            _journey.note_batch_wait(
                self.JOURNEY_STAGE, sum(max(0.0, t_flush0 - q.t_enq)
                                        for q in batch if q.t_enq))
        t_svc0 = time.perf_counter()
        with _flight.dispatch(
                self.FAMILY, corr_ids=_flight.corr_ids(corrs),
                n_real=len(batch), lanes=len(batch),
                breaker_state=brk.state) as rec:
            with trace.span(f"{self.FAMILY}/flush", corr=corrs,
                            dispatch_id=rec["dispatch_id"],
                            queries=len(batch)):
                self._flush_ctx = (t_flush0, t_svc0, rec)
                try:
                    await self._flush_batch_inner(batch, brk, rec)
                finally:
                    self._flush_ctx = None
            # a flush that completed without a device dispatch ran the
            # host path; set only on success, so a crashed flush seals
            # as "error"
            if rec["outcome"] is None:
                rec["outcome"] = "host"

    async def _flush_batch_inner(self, batch: list, brk, rec: dict) -> None:
        self.M["batch"].observe(len(batch))
        g = self.get_map()
        if g is None:
            for q in batch:
                self._resolve(q, "host", self._no_graph())
            return
        host, device = self._screen(batch)
        if device and not brk.allow():
            # breaker open: the device share fails with BreakerOpen.
            # allow() is consulted only once a dispatch is certain to
            # follow: a half-open probe token is always settled by the
            # record_success / record_failure below
            rec["outcome"] = "breaker"
            err = _breaker.BreakerOpen(self.FAMILY, brk.retry_in_s())
            for q in device:
                self._resolve(q, "device", ("error", err))
            device = []
        if device:
            lanes = -(-len(device) // self.batch) * self.batch
            rec["n_real"] = len(device)
            rec["lanes"] = lanes
            rec["occupancy"] = round(len(device) / lanes, 4)
            io_acct: dict = {}
            try:
                with trace.annotation(f"{self.FAMILY}/dispatch",
                                      self.device):
                    results = await self._solve(g, device, io_acct)
                self.M["occupancy"].observe(len(device) / lanes)
                brk.record_success()
                rec["outcome"] = "ok"
                rec["h2d_bytes"] = io_acct.get("h2d_bytes", 0)
                rec["d2h_bytes"] = io_acct.get("d2h_bytes", 0)
            except _deadline.DeadlineExceeded as e:
                brk.record_failure()
                rec["outcome"] = "deadline"
                log.warning("%s dispatch blew its deadline; its %d "
                            "queries fail", self.FAMILY, len(device))
                self._fail_device(device, e)
                results, device = [], []
            except Exception as e:
                brk.record_failure()
                rec["outcome"] = "error"
                rec["error"] = type(e).__name__
                log.error("%s dispatch failed (%s); its %d queries fail",
                          self.FAMILY, e, len(device))
                self._fail_device(device, e)
                results, device = [], []
            for q, res in zip(device, results):
                if res[0] == "fallback":
                    host.append((q, res[1]))
                else:
                    self._resolve(q, "device", res)
        # ON the event loop, deliberately: accepted channel_updates
        # mutate the live Gossmap from the loop, and the host solvers
        # read those arrays live; the device path reads its planes
        for _, reason in host:
            self.M["fallback"].labels(reason).inc()
        for q, _ in host:
            self._resolve(q, "host", self._host_solve(g, q))
            await asyncio.sleep(0)

    def _fail_device(self, device: list, err: BaseException) -> None:
        for q in device:
            self._resolve(q, "device", ("error", err))

    async def _dispatch(self, fn, *args, first: bool = True):
        """One dispatch round of ``fn(*args)`` in a worker thread under
        the deadline.  The first round of a flush fires the ``dispatch``
        fault seam, on the loop and inside the deadline, so an injected
        hang blows the deadline as a hung card would."""
        async def run():
            if first:
                _fault.fire("dispatch", self.FAMILY)
            return await asyncio.to_thread(fn, *args)
        return await _deadline.guard(run(), self.deadline_s, self.FAMILY,
                                     "dispatch")

    def _screen(self, batch: list) -> tuple[list, list]:
        raise NotImplementedError

    async def _solve(self, g, device: list, io_acct: dict) -> list:
        raise NotImplementedError

    def _no_graph(self) -> tuple:
        raise NotImplementedError

    def _host_solve(self, g, q) -> tuple:
        raise NotImplementedError

    def _resolve(self, q, path: str, res: tuple) -> None:
        raise NotImplementedError


class RouteService(FlushService):
    """Coalesce concurrent getroute queries into batched sweeps on the
    card.

    ``getroute()`` is a drop-in awaitable for dijkstra.getroute: same
    arguments, same return shapes, same NoRoute / KeyError behaviour.
    """

    FAMILY = "route"
    FLUSH_MS = ROUTE_FLUSH_MS
    BATCH = ROUTE_BATCH
    HIGH_WM = ROUTE_HIGH_WM
    M = {"flush_seconds": _families.ROUTE_FLUSH_SECONDS,
         "batch": _families.ROUTE_BATCH_QUERIES,
         "occupancy": _families.ROUTE_OCCUPANCY,
         "queries": _families.ROUTE_QUERIES,
         "fallback": _families.ROUTE_FALLBACK,
         "queue": _families.ROUTE_QUEUE}

    async def getroute(self, source: bytes, destination: bytes,
                       amount_msat: int, final_cltv: int = 18,
                       riskfactor: int = DJ.DEFAULT_RISKFACTOR,
                       max_hops: int = DEFAULT_MAX_HOPS,
                       excluded_scids: set | None = None,
                       with_source: bool = False):
        g = self.get_map()
        if g is None:
            raise NoRoute("no gossip graph loaded")
        if source == destination:
            raise NoRoute("source is destination")
        # the enqueue span: the carrier minted here rides the query into
        # the flush, so the exported timeline flows this call to the
        # batched dispatch that solved it
        with trace.span("route/enqueue"):
            q = RouteQuery(
                source, destination, int(amount_msat), int(final_cltv),
                int(riskfactor), int(max_hops), excluded_scids,
                future=self._admit(), corr=trace.new_corr())
            self._enqueue(q)
        route, src_info = await q.future
        return (route, src_info) if with_source else route

    def _screen(self, batch: list[RouteQuery]) -> tuple[list, list]:
        host: list[tuple[RouteQuery, str]] = []
        device: list[RouteQuery] = []
        for q in batch:
            # [0, cap] screens: NEGATIVE values are as dangerous as
            # oversized ones (they slide under the sweep's a_v > thr
            # overflow test)
            if not 0 <= q.amount_msat <= ROUTE_MAX_AMOUNT_MSAT:
                host.append((q, R_AMOUNT_CAP))
            elif not 0 <= q.riskfactor <= ROUTE_MAX_RISKFACTOR:
                host.append((q, R_RISKFACTOR_CAP))
            elif q.max_hops != DEFAULT_MAX_HOPS:
                host.append((q, R_MAX_HOPS))
            else:
                device.append(q)
        return host, device

    async def _solve(self, g, device: list[RouteQuery],
                     io_acct: dict) -> list:
        self._planes = RoutePlanes.current(g, self._planes, self.device)
        return await self._dispatch(solve_batch, self._planes, device,
                                    self.batch, io_acct)

    def _no_graph(self) -> tuple:
        return ("noroute", "no gossip graph loaded")

    def _host_solve(self, g, q: RouteQuery) -> tuple:
        try:
            route, src_info = DJ.getroute(
                g, q.source, q.destination, q.amount_msat,
                final_cltv=q.final_cltv, riskfactor=q.riskfactor,
                max_hops=q.max_hops, excluded_scids=q.excluded_scids,
                with_source=True)
            return ("ok", route, src_info)
        except NoRoute as e:
            return ("noroute", str(e))
        except Exception as e:
            return ("error", e)

    def _resolve(self, q: RouteQuery, path: str, res: tuple) -> None:
        fut = q.future
        if fut.done():
            return
        if res[0] == "ok":
            self.M["queries"].labels(path, "ok").inc()
            fut.set_result((res[1], res[2]))
        elif res[0] == "noroute":
            self.M["queries"].labels(path, "noroute").inc()
            fut.set_exception(NoRoute(res[1]))
        else:
            self.M["queries"].labels(path, "error").inc()
            err = res[1]
            fut.set_exception(err if isinstance(err, BaseException)
                              else RuntimeError(str(err)))
