"""Gossmap: the routing graph as structure-of-arrays (the port's copy).

After Core Lightning's common/gossmap.c (an mmap'd structure-of-arrays
graph) and plugins/topology.c's listchannels / listnodes views.  The
graph is flat numpy arrays from the start, built with the same native
gathers as the verify path, with no per-record Python objects.

Layout:
  nodes:    node_ids (N,33) uint8, sorted-unique
  channels: scids (C,) u64 sorted; node1/node2 (C,) int32 into nodes;
            per-direction update arrays (2,C): enabled, cltv_delta,
            htlc_min/max_msat, fee_base_msat, fee_ppm, timestamp
  adjacency: CSR over directed edges keyed by destination: adj_off
            (N+1,), adj_chan, adj_dir, adj_src
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import native
from . import wire
from .store import StoreIndex

# bounded (channel, direction) change log capacity: past this the log
# halves (oldest entries dropped) and consumers whose cursor fell off
# the base do one full parameter refresh instead of a patch
_PARAM_LOG_CAP = 4096


def scid_str(scid: int) -> str:
    """Display form BLOCKxTXxOUT (Core Lightning's short_channel_id form)."""
    return f"{scid >> 40}x{(scid >> 16) & 0xFFFFFF}x{scid & 0xFFFF}"


def scid_parse(s) -> int:
    if isinstance(s, int):
        return s
    b, t, o = s.split("x")
    return (int(b) << 40) | (int(t) << 16) | int(o)


@dataclass
class Gossmap:
    node_ids: np.ndarray  # (N, 33) uint8
    scids: np.ndarray  # (C,) uint64, sorted
    node1: np.ndarray  # (C,) int32
    node2: np.ndarray  # (C,) int32
    capacity_sat: np.ndarray  # (C,) float32 (fp16-compressible)
    # per-direction (2, C): direction d = from node_{d+1}'s side
    enabled: np.ndarray  # bool
    cltv_delta: np.ndarray  # uint16
    htlc_min_msat: np.ndarray  # uint64
    htlc_max_msat: np.ndarray  # uint64
    fee_base_msat: np.ndarray  # uint32
    fee_ppm: np.ndarray  # uint32
    timestamps: np.ndarray  # uint32
    # CSR adjacency over directed, update-bearing edges, keyed by
    # DESTINATION node: routing runs backward from the destination, so
    # the scan "edges INTO v" must see every direction that has an
    # update, including channels updated in only one direction
    adj_off: np.ndarray = field(default=None)  # (N+1,) by dst node
    adj_chan: np.ndarray = field(default=None)  # (E,) int32 channel index
    adj_dir: np.ndarray = field(default=None)  # (E,) int8 direction
    adj_src: np.ndarray = field(default=None)  # (E,) int32 source node
    # version counters for consumers that cache the graph: params bumps
    # on any accepted update's field change, topology on edge-set changes
    topology_version: int = 0
    params_version: int = 0
    # set instead of rebuilding eagerly: a gossip-sync burst of
    # first-in-direction updates would otherwise pay one O(E log E)
    # _build_adjacency per message on the event loop — readers call
    # ensure_adjacency() and the batch costs ONE rebuild
    _adjacency_dirty: bool = False
    # bounded (channel_index, direction) log of accepted updates since
    # construction: a consumer keeps a cursor into it and patches only
    # the touched edges on a params bump instead of re-deriving all
    _param_log: list = field(default_factory=list)
    _param_log_base: int = 0

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def n_channels(self) -> int:
        return len(self.scids)

    def node_index(self, node_id: bytes) -> int:
        ids = self.node_ids.view([("k", "V33")]).reshape(-1)
        key = np.frombuffer(node_id, np.uint8).view([("k", "V33")])
        i = np.searchsorted(ids, key[0])
        if i >= len(ids) or ids[i] != key[0]:
            raise KeyError(f"unknown node {node_id.hex()[:16]}")
        return int(i)

    def channel_index(self, scid: int) -> int:
        i = int(np.searchsorted(self.scids, scid))
        if i >= len(self.scids) or self.scids[i] != scid:
            raise KeyError(f"unknown scid {scid}")
        return i

    def _build_adjacency(self) -> None:
        # directed edge exists where direction d has an update;
        # source of (chan c, dir d) is node1 if d==0 else node2
        srcs, chans, dirs, dsts = [], [], [], []
        for d in (0, 1):
            idx = np.nonzero(self.timestamps[d] > 0)[0]
            src = self.node1[idx] if d == 0 else self.node2[idx]
            dst = self.node2[idx] if d == 0 else self.node1[idx]
            srcs.append(src)
            dsts.append(dst)
            chans.append(idx)
            dirs.append(np.full(len(idx), d, np.int8))
        dst = np.concatenate(dsts)
        order = np.argsort(dst, kind="stable")
        dst = dst[order]
        self.adj_chan = np.concatenate(chans)[order].astype(np.int32)
        self.adj_dir = np.concatenate(dirs)[order]
        self.adj_src = np.concatenate(srcs)[order].astype(np.int32)
        counts = np.bincount(dst, minlength=self.n_nodes)
        self.adj_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.topology_version += 1
        self.params_version += 1
        self._adjacency_dirty = False

    def ensure_adjacency(self) -> None:
        """Rebuild the CSR if updates marked it dirty (or it was never
        built).  Every adjacency reader enters through here."""
        if self._adjacency_dirty or self.adj_off is None:
            self._build_adjacency()

    def apply_channel_update(self, scid: int, direction: int, *,
                             timestamp: int, disabled: bool,
                             cltv_delta: int, htlc_min_msat: int,
                             htlc_max_msat: int, fee_base_msat: int,
                             fee_ppm: int) -> bool:
        """Fold one ACCEPTED (signature-verified) channel_update into
        the live graph, bumping the version counters consumers key on
        (a cached copy refreshes its parameters on a params bump and is
        rebuilt on a topology bump).

        Returns False for stale timestamps and for scids this graph
        does not carry.  The latter includes channels ANNOUNCED after
        the graph was built: the SoA arrays are fixed-size, so new
        channels only enter through a map rebuild (`from_store`); until
        then their updates are durably in the store but invisible to
        routing.  Live announcement folding
        (growing node/channel arrays in place) is an open follow-on."""
        try:
            c = self.channel_index(scid)
        except KeyError:
            return False
        d = int(direction) & 1
        if timestamp <= int(self.timestamps[d, c]):
            return False
        first_update = self.timestamps[d, c] == 0
        self.timestamps[d, c] = timestamp
        self.enabled[d, c] = not disabled
        self.cltv_delta[d, c] = cltv_delta
        self.htlc_min_msat[d, c] = htlc_min_msat
        self.htlc_max_msat[d, c] = htlc_max_msat
        self.fee_base_msat[d, c] = fee_base_msat
        self.fee_ppm[d, c] = fee_ppm
        if first_update:
            # a direction gained its first update: new directed edge.
            # Mark dirty (readers rebuild once per batch, not per msg);
            # bump the topology counter NOW so snapshots taken
            # before the rebuild are already invalidated.
            self._adjacency_dirty = True
            self.topology_version += 1
        self.params_version += 1
        # change log for incremental refreshes; bounded — on
        # overflow the oldest half drops and stale cursors fall back
        # to a full refresh (param_entries_since returns None)
        self._param_log.append((c, d))
        if len(self._param_log) > _PARAM_LOG_CAP:
            drop = len(self._param_log) - _PARAM_LOG_CAP // 2
            del self._param_log[:drop]
            self._param_log_base += drop
        return True

    @property
    def param_log_pos(self) -> int:
        """Cursor value covering every update logged so far."""
        return self._param_log_base + len(self._param_log)

    def param_entries_since(self, pos: int) -> list | None:
        """(channel_index, direction) pairs accepted since cursor
        `pos`, or None when the log no longer reaches back that far
        (the caller must do a full parameter refresh)."""
        if pos < self._param_log_base:
            return None
        return self._param_log[pos - self._param_log_base:]

    # -- views (plugins/topology.c:270 listchannels / :408 listnodes) -----

    def listnodes(self) -> list[dict]:
        return [{"nodeid": bytes(self.node_ids[i]).hex()}
                for i in range(self.n_nodes)]

    def listchannels(self) -> list[dict]:
        out = []
        for c in range(self.n_channels):
            for d in (0, 1):
                if self.timestamps[d, c] == 0:
                    continue
                src = self.node1[c] if d == 0 else self.node2[c]
                dst = self.node2[c] if d == 0 else self.node1[c]
                out.append({
                    "source": bytes(self.node_ids[src]).hex(),
                    "destination": bytes(self.node_ids[dst]).hex(),
                    "short_channel_id": scid_str(int(self.scids[c])),
                    "direction": d,
                    "active": bool(self.enabled[d, c]),
                    "base_fee_millisatoshi": int(self.fee_base_msat[d, c]),
                    "fee_per_millionth": int(self.fee_ppm[d, c]),
                    "delay": int(self.cltv_delta[d, c]),
                    "htlc_minimum_msat": int(self.htlc_min_msat[d, c]),
                    "htlc_maximum_msat": int(self.htlc_max_msat[d, c]),
                })
        return out


def _scids_from(buf, off, scid_off) -> np.ndarray:
    raw = native.gather_fields(buf, off, scid_off, 8).astype(np.uint64)
    scid = np.zeros(len(off), np.uint64)
    for b in range(8):
        scid = (scid << np.uint64(8)) | raw[:, b]
    return scid


def from_store(idx: StoreIndex, default_capacity_sat: int = 0) -> Gossmap:
    """Build the graph from a (verified) store in one vectorized pass.
    Core Lightning rebuilds its gossmap by mmap-scanning the same file
    (common/gossmap.c); capacities come from the chain backend there;
    here default_capacity_sat (0 = unknown) is used."""
    alive = idx.select(idx.alive())
    ca = alive.select(alive.types == wire.MSG_CHANNEL_ANNOUNCEMENT)
    cu = alive.select(alive.types == wire.MSG_CHANNEL_UPDATE)

    # --- channels + nodes from announcements
    n = len(ca)
    off = ca.offsets
    flen_raw = native.gather_fields(ca.buf, off, wire.CA_FLEN_OFFSET, 2)
    flen = (flen_raw[:, 0].astype(np.uint64) << 8) | flen_raw[:, 1]
    scids = _scids_from(ca.buf, off + flen, wire.CA_FLEN_OFFSET + 2 + 32)
    key_base = wire.CA_FLEN_OFFSET + 2 + flen + 40
    node1_ids = native.gather_fields(ca.buf, off + key_base, 0, 33)
    node2_ids = native.gather_fields(ca.buf, off + key_base, 33, 33)

    order = np.argsort(scids, kind="stable")
    scids, node1_ids, node2_ids = scids[order], node1_ids[order], node2_ids[order]
    # deduplicate scids (later records win — store append order)
    keep = np.ones(n, bool)
    if n:
        keep[:-1] = scids[:-1] != scids[1:]
    scids, node1_ids, node2_ids = scids[keep], node1_ids[keep], node2_ids[keep]
    n = len(scids)

    all_ids = np.concatenate([node1_ids, node2_ids]) if n else \
        np.zeros((0, 33), np.uint8)
    uniq, inverse = np.unique(all_ids.view([("k", "V33")]).reshape(-1),
                              return_inverse=True)
    node_ids = uniq.view(np.uint8).reshape(-1, 33)
    node1 = inverse[:n].astype(np.int32)
    node2 = inverse[n:].astype(np.int32)

    # --- per-direction updates
    enabled = np.zeros((2, n), bool)
    cltv = np.zeros((2, n), np.uint16)
    hmin = np.zeros((2, n), np.uint64)
    hmax = np.zeros((2, n), np.uint64)
    base = np.zeros((2, n), np.uint32)
    ppm = np.zeros((2, n), np.uint32)
    ts = np.zeros((2, n), np.uint32)
    m = len(cu)
    if m:
        offu = cu.offsets
        u_scid = _scids_from(cu.buf, offu, wire.CU_SCID_OFFSET)
        u_ts = native.gather_fields(cu.buf, offu, wire.CU_SCID_OFFSET + 8, 4)
        u_ts = ((u_ts[:, 0].astype(np.uint32) << 24)
                | (u_ts[:, 1].astype(np.uint32) << 16)
                | (u_ts[:, 2].astype(np.uint32) << 8) | u_ts[:, 3])
        fl = native.gather_fields(cu.buf, offu, wire.CU_FLAGS_OFFSET, 2)
        mflags, cflags = fl[:, 0], fl[:, 1]
        direction = (cflags & 1).astype(np.int8)
        disabled = (cflags & 2) != 0
        body = native.gather_fields(cu.buf, offu, wire.CU_FLAGS_OFFSET + 2, 18)

        def be(a, o, w):
            v = np.zeros(len(a), np.uint64)
            for b in range(w):
                v = (v << np.uint64(8)) | a[:, o + b]
            return v

        u_cltv = be(body, 0, 2)
        u_hmin = be(body, 2, 8)
        u_base = be(body, 10, 4)
        u_ppm = be(body, 14, 4)
        # htlc_maximum_msat is optional (message_flags bit 0 + length);
        # gathering it unconditionally would read past short legacy
        # records (gather_fields is an unchecked memcpy)
        u_hmax = np.zeros(m, np.uint64)
        has_max = ((mflags & 1) != 0) & (
            cu.lengths >= wire.CU_FLAGS_OFFSET + 2 + 26)
        li = np.nonzero(has_max)[0]
        if len(li):
            maxb = native.gather_fields(
                cu.buf, offu[li], wire.CU_FLAGS_OFFSET + 2 + 18, 8)
            u_hmax[li] = be(maxb, 0, 8)

        pos = np.searchsorted(scids, u_scid)
        pos_c = np.clip(pos, 0, max(0, n - 1))
        found = (pos < n) & (scids[pos_c] == u_scid) if n else \
            np.zeros(m, bool)
        # keep the NEWEST update per (channel, direction) — vectorized:
        # sort by (chan, dir, ts) and take the last row of each group
        fi = np.nonzero(found)[0]
        if len(fi):
            key = pos_c[fi].astype(np.int64) * 2 + direction[fi]
            order = np.lexsort((u_ts[fi], key))
            ordered, okey = fi[order], key[order]
            last = np.ones(len(ordered), bool)
            last[:-1] = okey[:-1] != okey[1:]
            sel = ordered[last]
            c, d = pos_c[sel], direction[sel]
            ts[d, c] = u_ts[sel]
            enabled[d, c] = ~disabled[sel]
            cltv[d, c] = u_cltv[sel]
            hmin[d, c] = u_hmin[sel]
            hmax[d, c] = u_hmax[sel]
            base[d, c] = u_base[sel]
            ppm[d, c] = u_ppm[sel]

    g = Gossmap(
        node_ids=node_ids, scids=scids, node1=node1, node2=node2,
        capacity_sat=np.full(n, default_capacity_sat, np.float32),
        enabled=enabled, cltv_delta=cltv, htlc_min_msat=hmin,
        htlc_max_msat=hmax, fee_base_msat=base, fee_ppm=ppm, timestamps=ts,
    )
    g._build_adjacency()
    return g
