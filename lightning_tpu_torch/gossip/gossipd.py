"""The gossipd service: live peer gossip in/out around the batched
verifier.

Parity targets:
 - connectd/multiplex.c:829 `handle_gossip_in` (peer bytes → gossipd)
   and :599 `wake_gossip` (store → every peer, filtered) — here the
   ingest's on_accept fan-out plus gossip_timestamp_filter state.
 - gossipd/queries.c + connectd/queries.c: query_channel_range /
   query_short_channel_ids / reply handling (BOLT#7 encoding type 0).
 - gossipd/seeker.c:28: the catch-up state machine a fresh node runs
   against its first peer (filter → range query → scid query → ingest).

The crypto-heavy part stays in GossipIngest (batched verify on the
card: K1 -> K2 -> K3); this module is the host-side shell that makes it a
daemon.  The port's own copy of the JAX package's gossip/gossipd.py: the
card is reached in two places, the ingest's flushes and
``load_existing(verify=True)``'s replay, both on ``device`` (the card
unless device="cpu").  The ingest's knobs (watermarks, deadline) are
arguments.

The bulk replies (a filter's backfill, a scid query's messages) go to
the socket SEND_BATCH messages a write, where the JAX package writes each
message alone: the same frames in the same order, in fewer writes (with a
verify flush busy on another thread, each socket write of the event loop
can wait long for the interpreter lock).  Two departures from the JAX
package, both silent below their triggers, where the two answer byte for
byte alike:

 - encoded_short_ids has a u16 length, so a reply_channel_range or a
   query_short_channel_ids holds at most 8,191 scids; past MAX_SCIDS the
   port splits them (BOLT #7: replies of whole blocks that together cover
   the query's range; one query in flight at a time), where the JAX
   package fails to encode the reply and drops the peer.
 - The ingest sheds under overload, and a peer sends a message once, so
   a shed update of a channel already known would never come back: the
   port remembers the channels of shed gossip (``on_shed``) and asks for
   them again with the next range reply's query.
"""
from __future__ import annotations

import asyncio
import logging
import struct
import time

from ..obs import journey as _journey
from ..wire import messages as M
from . import wire as gwire
from .ingest import GossipIngest, _journey_entity

log = logging.getLogger("lightning_tpu_torch.gossipd")

ENC_UNCOMPRESSED = 0
# scids a reply_channel_range or query_short_channel_ids carries at most
# (its encoded_short_ids, 1 + 8 a scid bytes, has a u16 length)
MAX_SCIDS = 8000
# stored messages a bulk reply writes to the socket at once
SEND_BATCH = 256


def encode_scids(scids: list[int]) -> bytes:
    return bytes([ENC_UNCOMPRESSED]) + b"".join(
        s.to_bytes(8, "big") for s in sorted(scids))


def decode_scids(blob: bytes) -> list[int]:
    if not blob:
        return []
    if blob[0] != ENC_UNCOMPRESSED:
        raise ValueError(f"unsupported scid encoding {blob[0]}")
    body = blob[1:]
    if len(body) % 8:
        raise ValueError("ragged encoded_short_ids")
    return [int.from_bytes(body[i:i + 8], "big")
            for i in range(0, len(body), 8)]


def scid_block(scid: int) -> int:
    return scid >> 40


def range_chunks(scids: list[int], lo: int, hi: int) -> list[tuple]:
    """The replies to a query of blocks [lo, hi): (first_blocknum,
    number_of_blocks, scids) with at most MAX_SCIDS sorted scids each,
    cut at block boundaries (inside a block only when one block holds
    more), together covering [lo, hi).  One reply when they fit."""
    scids = sorted(scids)
    if len(scids) <= MAX_SCIDS:
        return [(lo, hi - lo, scids)]
    out, first, start = [], lo, 0
    while start < len(scids):
        end = min(start + MAX_SCIDS, len(scids))
        if end < len(scids):
            cut = end
            while cut > start and scid_block(scids[cut - 1]) == \
                    scid_block(scids[end]):
                cut -= 1
            end = cut if cut > start else end
        nxt = hi if end == len(scids) else scid_block(scids[end])
        out.append((first, nxt - first, scids[start:end]))
        first, start = nxt, end
    return out


class Gossipd:
    """Attach to a LightningNode: ingest, answer queries, stream out."""

    def __init__(self, node, store_path: str,
                 chain_hash: bytes = gwire.MAINNET_CHAIN_HASH,
                 utxo_check=None, flush_ms: float = 2.0,
                 flush_size: int = 256, bucket: int | None = None,
                 gossmap_ref: dict | None = None, device=None,
                 deadline_s: float | None = None,
                 high_wm: int | None = None, low_wm: int | None = None):
        from . import verify as _gv

        bucket = bucket if bucket is not None else _gv.DEFAULT_BUCKET
        self.node = node
        self.chain_hash = chain_hash
        # mutable {'map': Gossmap|None} holder (the daemon's routing
        # view): accepted channel_updates are folded into it live so
        # the route planes refresh instead of waiting for a reload
        self.gossmap_ref = gossmap_ref or {}
        self.ingest = GossipIngest(
            store_path, utxo_check=utxo_check, flush_ms=flush_ms,
            flush_size=flush_size, bucket=bucket,
            on_accept=self._on_accept, on_shed=self._on_shed,
            # own-node/own-channel gossip sheds LAST under overload
            own_node_id=getattr(node, "node_id", None),
            # the JAX package's watermark knobs: low defaults to half the
            # high one, and the pending maps' bound follows the high one
            high_wm=high_wm,
            low_wm=low_wm or (high_wm // 2 if high_wm else None),
            pending_cap=max(1024, high_wm) if high_wm else None,
            deadline_s=deadline_s, device=device)
        self.device = self.ingest.device
        # raw message cache for query replies (the store is the durable
        # copy; this is the reference's gossmap offset index role)
        self.msgs: dict[int, dict] = {}       # scid -> {ca, cu0, cu1}
        self.node_msgs: dict[bytes, bytes] = {}  # node_id -> na raw
        self.filters: dict[bytes, tuple[int, int]] = {}  # peer -> (t0, dt)
        self._synced: dict[bytes, asyncio.Event] = {}
        # a sync's range replies so far: peer -> [query end, scids]
        self._ranges: dict[bytes, list] = {}
        # query_short_channel_ids still to send: peer -> [scid lists]
        self._queries: dict[bytes, list] = {}
        # channels (and nodes) whose gossip the ingest shed: asked again
        self._shed_scids: set[int] = set()
        self._shed_nodes: set[bytes] = set()
        # we sent THEM a filter — keyed by the Peer OBJECT (WeakSet):
        # filter state is per-connection (BOLT#7), so a reconnect's new
        # Peer must get a fresh filter or the remote streams us nothing
        import weakref

        self._filter_sent = weakref.WeakSet()
        self._fanout: set[asyncio.Task] = set()   # sends to peers in flight

        for t in (gwire.MSG_CHANNEL_ANNOUNCEMENT,
                  gwire.MSG_NODE_ANNOUNCEMENT, gwire.MSG_CHANNEL_UPDATE):
            node.raw_handlers[t] = self._on_gossip
        node.register(M.QueryChannelRange, self._on_query_range)
        node.register(M.ReplyChannelRange, self._on_reply_range)
        node.register(M.QueryShortChannelIds, self._on_query_scids)
        node.register(M.ReplyShortChannelIdsEnd, self._on_scids_end)
        node.register(M.GossipTimestampFilter, self._on_filter)

    def load_existing(self, store_path: str, verify: bool = False,
                      idx=None) -> int:
        """Rebuild the in-memory view from an existing store (restart
        path; common/gossmap.c:749's load role).  verify=True replays
        every signature through the batched verify on this gossipd's
        device first (tools/bench-gossipd.sh's store_load workload).
        idx: an already-loaded StoreIndex for this path (saves the second
        scan when the daemon also built a Gossmap from the same file)."""
        import os

        from . import store as gstore

        if idx is None:
            if not os.path.exists(store_path):
                return 0
            if os.path.getsize(store_path) <= 1:
                return 0  # fresh store: version byte only (just created)
            idx = gstore.load_store(store_path)  # corrupt store DOES raise
        alive = idx.select(idx.alive())
        if verify:
            from . import verify as gverify

            res = gverify.verify_store(alive, device=self.device)
            if not (res.ca_valid.all() and res.cu_valid.all()
                    and res.na_valid.all()):
                raise ValueError("store failed replay verification")
        n = 0
        for i in range(len(alive)):
            raw = alive.message(i)
            try:
                p = gwire.parse_gossip(raw)
            except Exception:
                continue
            t = gwire.msg_type(raw)
            ing = self.ingest
            if t == gwire.MSG_CHANNEL_ANNOUNCEMENT:
                ing.channels[p.short_channel_id] = (p.node_id_1, p.node_id_2)
                ing._channeled_nodes.update((p.node_id_1, p.node_id_2))
                self.msgs.setdefault(p.short_channel_id, {})["ca"] = raw
            elif t == gwire.MSG_CHANNEL_UPDATE:
                key = (p.short_channel_id, p.direction)
                if ing.updates.get(key, -1) < p.timestamp:
                    ing.updates[key] = p.timestamp
                    self.msgs.setdefault(p.short_channel_id, {})[
                        f"cu{p.direction}"] = raw
            else:
                if ing.nodes.get(p.node_id, -1) < p.timestamp:
                    ing.nodes[p.node_id] = p.timestamp
                    self.node_msgs[p.node_id] = raw
            n += 1
        return n

    def start(self) -> None:
        self.ingest.start()

    async def close(self) -> None:
        await self.ingest.close()

    # -- ingest + fan-out -------------------------------------------------

    async def _on_gossip(self, peer, raw: bytes) -> None:
        # backpressure propagation: while the ingest
        # backlog is saturated this await pauses THIS peer's read pump
        # (the pump awaits its raw handler), so we stop draining the
        # socket and TCP pushes back on the sender instead of us
        # buffering its storm.  Bounded per message and released for
        # every peer together when the backlog drains — no peer
        # starves, and messages that still arrive saturated are shed
        # by priority inside submit(), metered, never silently lost.
        if _journey.enabled():
            # the journey's first hop: the raw bytes reached gossipd
            # from a peer.  Parse only when sampling is on — the hop
            # must not tax the disabled-by-default hot path.
            try:
                p = gwire.parse_gossip(raw)
            except Exception:
                p = None
            if p is not None:
                jk, jkey = _journey_entity(gwire.msg_type(raw), p)
                _journey.hop("recv", jk, jkey, outcome="ok")
        await self.ingest.wait_capacity()
        await self.ingest.submit(raw, source=peer.node_id)

    def _on_accept(self, raw: bytes, source) -> None:
        t = gwire.msg_type(raw)
        p = gwire.parse_gossip(raw)
        if t == gwire.MSG_CHANNEL_ANNOUNCEMENT:
            self.msgs.setdefault(p.short_channel_id, {})["ca"] = raw
        elif t == gwire.MSG_CHANNEL_UPDATE:
            self.msgs.setdefault(p.short_channel_id, {})[
                f"cu{p.direction}"] = raw
            g = self.gossmap_ref.get("map")
            if g is not None:
                t0 = time.perf_counter()
                g.apply_channel_update(
                    p.short_channel_id, p.direction,
                    timestamp=p.timestamp,
                    disabled=bool(p.channel_flags & 2),
                    cltv_delta=p.cltv_expiry_delta,
                    htlc_min_msat=p.htlc_minimum_msat,
                    htlc_max_msat=p.htlc_maximum_msat,
                    fee_base_msat=p.fee_base_msat,
                    fee_ppm=p.fee_proportional_millionths)
                _journey.hop("fold", "channel", p.short_channel_id,
                             outcome="ok",
                             service_s=time.perf_counter() - t0,
                             direction=int(p.direction))
        else:
            self.node_msgs[p.node_id] = raw
        ts = getattr(p, "timestamp", int(time.time()))
        loop = asyncio.get_event_loop()
        for peer in list(self.node.peers.values()):
            if peer.node_id == source or not peer.connected:
                continue
            flt = self.filters.get(peer.node_id)
            if flt is None:
                continue      # peer never asked for gossip
            t0, dt = flt
            if t == gwire.MSG_CHANNEL_ANNOUNCEMENT or t0 <= ts < t0 + dt:
                task = loop.create_task(peer.send_raw(raw))
                self._fanout.add(task)      # the loop holds tasks weakly
                task.add_done_callback(self._fanout.discard)

    # -- query answering (gossipd/queries.c) ------------------------------

    async def _on_query_range(self, peer, msg: M.QueryChannelRange) -> None:
        lo = msg.first_blocknum
        hi = lo + msg.number_of_blocks
        scids = [s for s in self.ingest.channels
                 if lo <= scid_block(s) < hi]
        for first, n_blocks, part in range_chunks(scids, lo, hi):
            await peer.send(M.ReplyChannelRange(
                chain_hash=msg.chain_hash, first_blocknum=first,
                number_of_blocks=n_blocks, sync_complete=1,
                encoded_short_ids=encode_scids(part)))

    async def _on_query_scids(self, peer,
                              msg: M.QueryShortChannelIds) -> None:
        try:
            scids = decode_scids(msg.encoded_short_ids)
        except ValueError:
            await peer.send(M.ReplyShortChannelIdsEnd(
                chain_hash=msg.chain_hash, full_information=0))
            return
        full = 1
        sent_nodes: set[bytes] = set()
        out: list[bytes] = []
        for s in scids:
            entry = self.msgs.get(s)
            if entry is None or "ca" not in entry:
                full = 0
                continue
            out.append(entry["ca"])
            for k in ("cu0", "cu1"):
                if k in entry:
                    out.append(entry[k])
            for nid in self.ingest.channels.get(s, ()):
                na = self.node_msgs.get(nid)
                if na is not None and nid not in sent_nodes:
                    sent_nodes.add(nid)
                    out.append(na)
            if len(out) >= SEND_BATCH:
                await peer.send_raw_many(out)
                out = []
        await peer.send_raw_many(out)
        await peer.send(M.ReplyShortChannelIdsEnd(
            chain_hash=msg.chain_hash, full_information=full))

    async def _on_filter(self, peer, msg: M.GossipTimestampFilter) -> None:
        self.filters[peer.node_id] = (msg.first_timestamp,
                                      msg.timestamp_range)
        # backfill everything already accepted that matches (connectd's
        # store-streaming role, simplified to the in-memory index)
        t0, dt = msg.first_timestamp, msg.timestamp_range
        out: list[bytes] = []
        for entry in list(self.msgs.values()):
            ca = entry.get("ca")
            if ca is not None:
                out.append(ca)
            for k in ("cu0", "cu1"):
                raw = entry.get(k)
                if raw is None:
                    continue
                ts = gwire.parse_gossip(raw).timestamp
                if t0 <= ts < t0 + dt:
                    out.append(raw)
            if len(out) >= SEND_BATCH:
                await peer.send_raw_many(out)
                out = []
        for raw in list(self.node_msgs.values()):
            ts = gwire.parse_gossip(raw).timestamp
            if t0 <= ts < t0 + dt:
                out.append(raw)
            if len(out) >= SEND_BATCH:
                await peer.send_raw_many(out)
                out = []
        await peer.send_raw_many(out)

    # -- seeker (gossipd/seeker.c) ----------------------------------------

    async def sync_with(self, peer, first_blocknum: int = 0,
                        number_of_blocks: int = 0xFFFFFFFF,
                        backfill_from: int = 0,
                        timeout: float = 30.0) -> int:
        """Catch up from one peer: set a timestamp filter, learn its scid
        set, fetch the ones we don't know.  Returns #scids requested.

        The filter is sent once per peer connection: re-sending it makes
        the peer re-backfill its whole store (our _on_filter streams the
        full backlog), which a periodic seeker probe must not trigger."""
        evt = asyncio.Event()
        self._synced[peer.node_id] = evt
        self._ranges[peer.node_id] = [first_blocknum + number_of_blocks, []]
        self._requested = 0
        if peer not in self._filter_sent:
            self._filter_sent.add(peer)
            await peer.send(M.GossipTimestampFilter(
                chain_hash=self.chain_hash, first_timestamp=backfill_from,
                timestamp_range=0xFFFFFFFF))
        await peer.send(M.QueryChannelRange(
            chain_hash=self.chain_hash, first_blocknum=first_blocknum,
            number_of_blocks=number_of_blocks))
        await asyncio.wait_for(evt.wait(), timeout)
        return self._requested

    async def _on_reply_range(self, peer, msg: M.ReplyChannelRange) -> None:
        try:
            theirs = decode_scids(msg.encoded_short_ids)
        except ValueError:
            return
        rng = self._ranges.get(peer.node_id)
        if rng is not None:
            rng[1] += theirs
            if msg.first_blocknum + msg.number_of_blocks < rng[0]:
                return            # more replies of this range follow
            theirs = self._ranges.pop(peer.node_id)[1]
        missing = [s for s in theirs if s not in self.ingest.channels]
        ask = sorted(set(missing) | self._take_shed())
        self._requested = len(ask)
        if ask:
            chunks = [ask[i:i + MAX_SCIDS]
                      for i in range(0, len(ask), MAX_SCIDS)]
            self._queries[peer.node_id] = chunks[1:]
            await peer.send(M.QueryShortChannelIds(
                chain_hash=msg.chain_hash,
                encoded_short_ids=encode_scids(chunks[0])))
        elif msg.sync_complete:
            evt = self._synced.get(peer.node_id)
            if evt is not None:
                evt.set()

    async def _on_scids_end(self, peer,
                            msg: M.ReplyShortChannelIdsEnd) -> None:
        rest = self._queries.get(peer.node_id)
        if rest:                  # the next query once this one is done
            await peer.send(M.QueryShortChannelIds(
                chain_hash=msg.chain_hash,
                encoded_short_ids=encode_scids(rest.pop(0))))
            return
        evt = self._synced.get(peer.node_id)
        if evt is not None:
            evt.set()

    # -- shed gossip, asked for again ---------------------------------------

    def _on_shed(self, kind: int, parsed, source) -> None:
        if kind == gwire.MSG_NODE_ANNOUNCEMENT:
            self._shed_nodes.add(parsed.node_id)
        else:
            self._shed_scids.add(parsed.short_channel_id)

    def _take_shed(self) -> set[int]:
        """The channels of the gossip shed since the last call: a shed
        node announcement by one accepted channel of its node (a peer
        answers a query for a channel with its nodes' announcements);
        nodes in no accepted channel wait for one."""
        scids, self._shed_scids = self._shed_scids, set()
        if self._shed_nodes:
            for scid, pair in self.ingest.channels.items():
                for nid in pair:
                    if nid in self._shed_nodes:
                        self._shed_nodes.discard(nid)
                        scids.add(scid)
        return scids
