"""RoutePlanes: the routing graph's directed edges as structure-of-arrays,
with torch copies on the planes' device for the batched Bellman-Ford
sweep (kernel R1, routing/device.py).

Derived from ``Gossmap._build_adjacency``'s destination-keyed CSR (the
same directed-edge universe the host dijkstra scans), flattened into
per-EDGE parameter planes (fee base/ppm, cltv delta, htlc min/max,
enabled, capacity) so the sweep never chases (direction, channel)
indices.  Shapes are quantized (nodes and edges pad to powers of two)
so graphs of similar size share one set of buffer shapes.

Freshness rides the Gossmap version counters: a param-only
channel_update (fees, enabled flip) patches just the touched edge lanes
or re-derives the parameter planes; a topology change (new channel,
first update in a direction) rebuilds everything.
``RoutePlanes.current()`` is the one entry point: callers always hold
planes that match the map they were given.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from ..obs import journey as _journey
from ..gossip.gossmap import Gossmap

# htlc_max is u64 on the wire; the device cost model runs in int64.
# Values past the clamp are "effectively unlimited" (2^62 msat is
# ~4.6e9 BTC) so clamping preserves routing semantics exactly.
_I64_CLAMP = (1 << 62) - 1

_MIN_NODE_PAD = 64
_MIN_EDGE_PAD = 256


def _note_planes_journey(g, entries, outcome: str) -> None:
    """A journey hop a refreshed (channel, direction) pair: the sampled
    channel_update's provenance ends here, the route planes picked its
    parameters up.  Nothing runs when sampling is off."""
    if not _journey.enabled():
        return
    for c, d in set(entries):
        _journey.hop("planes", "channel", int(g.scids[int(c)]),
                     outcome=outcome, direction=int(d))


def in_csr(edge_dst: np.ndarray, n_nodes: int) -> np.ndarray:
    """(n_nodes + 1,) int32 offsets of a destination-sorted edge list:
    node v's in-edges are in_off[v] .. in_off[v + 1] - 1."""
    return np.searchsorted(edge_dst, np.arange(n_nodes + 1),
                           "left").astype(np.int32)


def _pow2_pad(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


@dataclass
class RoutePlanes:
    """Edge-plane SoA view of one Gossmap revision.

    ``edge_*`` arrays are length ``e_pad``; rows past ``e_real`` are
    padding (``edge_enabled`` False, src/dst 0).  Node indices run to
    ``n_pad``; nodes past ``g.n_nodes`` have no in-edges and stay
    unreachable.  ``dev`` holds the torch copies on ``device``, uploaded
    by routing.device before a dispatch."""

    g: Gossmap
    topo_version: int
    params_version: int
    n_real: int
    n_pad: int
    e_real: int
    e_pad: int
    # host planes (numpy, canonical)
    edge_src: np.ndarray    # (E,) int32: forwarding node u of u->v
    edge_dst: np.ndarray    # (E,) int32: receiving node v
    edge_chan: np.ndarray   # (E,) int32: channel index into g.scids
    edge_dir: np.ndarray    # (E,) int8
    edge_base: np.ndarray   # (E,) int64 msat
    edge_ppm: np.ndarray    # (E,) int64
    edge_cltv: np.ndarray   # (E,) int64
    edge_hmin: np.ndarray   # (E,) int64 msat
    edge_hmax: np.ndarray   # (E,) int64 msat (0 = no cap)
    edge_enabled: np.ndarray  # (E,) bool
    edge_cap_sat: np.ndarray  # (E,) float32 (mcf consumers; not in cost)
    # (n_pad + 1,) int32: the in-edges of node v are in_off[v] ..
    # in_off[v + 1] - 1 (the real edges; R1's frontier reads them)
    in_off: np.ndarray = None
    device: torch.device = torch.device("cpu")
    dev: dict = field(default_factory=dict)
    # channel -> edge lookup (exclusion masks): edge indices sorted by chan
    _chan_order: np.ndarray = None
    _chan_sorted: np.ndarray = None
    # incremental-maintenance state: cursor into the gossmap's
    # (channel, direction) change log, and the edge lanes whose copies
    # in `dev` are stale against the (already patched) host planes;
    # routing.device scatters just those lanes before the next dispatch
    params_log_pos: int = 0
    patch_idx: np.ndarray | None = None

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, g: Gossmap, device=None) -> "RoutePlanes":
        """Planes of `g` for `device` (the card unless device="cpu")."""
        dev = D.resolve(device)
        g.ensure_adjacency()
        e_real = len(g.adj_chan)
        n_real = g.n_nodes
        n_pad = _pow2_pad(max(n_real, 1), _MIN_NODE_PAD)
        e_pad = _pow2_pad(max(e_real, 1), _MIN_EDGE_PAD)

        # destination node of each CSR edge = the CSR row it lives in
        counts = np.diff(g.adj_off)
        edge_dst = np.repeat(np.arange(n_real, dtype=np.int32),
                             counts.astype(np.int64))

        def _padded(a, dtype, fill=0):
            out = np.full(e_pad, fill, dtype)
            out[:e_real] = a
            return out

        c, d = g.adj_chan, g.adj_dir
        planes = cls(
            g=g,
            topo_version=g.topology_version,
            params_version=g.params_version,
            n_real=n_real, n_pad=n_pad, e_real=e_real, e_pad=e_pad,
            edge_src=_padded(g.adj_src, np.int32),
            edge_dst=_padded(edge_dst, np.int32),
            edge_chan=_padded(c, np.int32),
            edge_dir=_padded(d, np.int8),
            edge_base=_padded(g.fee_base_msat[d, c], np.int64),
            edge_ppm=_padded(g.fee_ppm[d, c], np.int64),
            edge_cltv=_padded(g.cltv_delta[d, c], np.int64),
            edge_hmin=_padded(
                np.minimum(g.htlc_min_msat[d, c], _I64_CLAMP), np.int64),
            edge_hmax=_padded(
                np.minimum(g.htlc_max_msat[d, c], _I64_CLAMP), np.int64),
            edge_enabled=_padded(g.enabled[d, c], bool, False),
            edge_cap_sat=_padded(g.capacity_sat[c], np.float32),
            in_off=in_csr(edge_dst, n_pad),
            device=dev,
            params_log_pos=g.param_log_pos,
        )
        planes._chan_order = np.argsort(
            planes.edge_chan[:e_real], kind="stable").astype(np.int64)
        planes._chan_sorted = planes.edge_chan[:e_real][planes._chan_order]
        return planes

    def with_fresh_params(self) -> "RoutePlanes":
        """Re-derive ONLY the per-edge parameter planes from the (same
        topology revision of the) gossmap.  Returns a NEW planes object
        sharing the topology arrays: a solve running on a worker thread
        keeps reading its own consistent revision."""
        g = self.g
        c = self.edge_chan[:self.e_real]
        d = self.edge_dir[:self.e_real]

        def _padded(a, dtype):
            out = np.zeros(self.e_pad, dtype)
            out[:self.e_real] = a
            return out

        return dataclasses.replace(
            self,
            params_version=g.params_version,
            params_log_pos=g.param_log_pos,
            patch_idx=None,
            edge_base=_padded(g.fee_base_msat[d, c], np.int64),
            edge_ppm=_padded(g.fee_ppm[d, c], np.int64),
            edge_cltv=_padded(g.cltv_delta[d, c], np.int64),
            edge_hmin=_padded(
                np.minimum(g.htlc_min_msat[d, c], _I64_CLAMP), np.int64),
            edge_hmax=_padded(
                np.minimum(g.htlc_max_msat[d, c], _I64_CLAMP), np.int64),
            edge_enabled=_padded(g.enabled[d, c], bool),
            # the parameter planes upload again at the next dispatch; the
            # topology planes carry over
            dev={k: v for k, v in self.dev.items()
                 if k in ("edge_src", "edge_dst")},
        )

    # touched-lane patching threshold: bursts touching more than this
    # share of the real edges re-derive everything
    _PATCH_MAX_FRACTION = 8   # e_real // 8

    def with_patched_params(self, entries) -> "RoutePlanes":
        """The incremental path for a channel_update burst: patch ONLY
        the edge lanes named by the gossmap's change-log `entries`
        ((channel_index, direction) pairs).  Returns a NEW planes object
        that shares the topology arrays and the uploaded tensors; the
        stale lanes are recorded in `patch_idx` and scattered on the
        device by routing.device before the next dispatch."""
        g = self.g
        idxs: set[int] = set()
        for c, d in set(entries):
            for e in self.edges_of_channel(int(c)):
                if int(self.edge_dir[e]) == int(d):
                    idxs.add(int(e))
        idx = np.array(sorted(idxs), np.int64)
        if self.patch_idx is not None:
            # an unapplied patch (no dispatch between two bursts) folds
            # into this one: the host arrays are canonical, so the union
            # of stale lanes re-reads the right values at apply
            idx = np.union1d(idx, self.patch_idx)
        c_arr = self.edge_chan[idx]
        d_arr = self.edge_dir[idx].astype(np.int64)

        def _patched(cur: np.ndarray, vals) -> np.ndarray:
            out = cur.copy()
            out[idx] = vals
            return out

        return dataclasses.replace(
            self,
            params_version=g.params_version,
            params_log_pos=g.param_log_pos,
            patch_idx=idx,
            edge_base=_patched(self.edge_base,
                               g.fee_base_msat[d_arr, c_arr]),
            edge_ppm=_patched(self.edge_ppm, g.fee_ppm[d_arr, c_arr]),
            edge_cltv=_patched(self.edge_cltv,
                               g.cltv_delta[d_arr, c_arr]),
            edge_hmin=_patched(self.edge_hmin, np.minimum(
                g.htlc_min_msat[d_arr, c_arr], _I64_CLAMP)),
            edge_hmax=_patched(self.edge_hmax, np.minimum(
                g.htlc_max_msat[d_arr, c_arr], _I64_CLAMP)),
            edge_enabled=_patched(self.edge_enabled,
                                  g.enabled[d_arr, c_arr]),
            # the tensors carry over WHOLE (patch_idx marks the stale
            # lanes); a copy of the dict, so applying the patch to this
            # revision never touches the predecessor's
            dev=dict(self.dev),
        )

    @classmethod
    def current(cls, g: Gossmap, cached: "RoutePlanes | None",
                device=None) -> "RoutePlanes":
        """The freshness gate: reuse `cached` when it matches `g`'s
        version counters; on a param-only bump patch just the touched
        edge lanes (the gossmap change log names them) or re-derive
        every param plane when the burst is too large or the log was
        trimmed; full rebuild on a topology change, a different map
        object or another device.  Never mutates `cached`."""
        if (cached is None or cached.g is not g
                or cached.device != D.resolve(device)
                or cached.topo_version != g.topology_version):
            return cls.build(g, device)
        if cached.params_version != g.params_version:
            entries = g.param_entries_since(cached.params_log_pos)
            # DISTINCT (channel, direction) pairs decide patch against
            # re-derive: a hot-channel burst logs many entries but
            # touches few lanes, which is what patching amortizes
            if entries is not None and len(set(entries)) <= max(
                    64, cached.e_real // cls._PATCH_MAX_FRACTION):
                fresh = cached.with_patched_params(entries)
                _note_planes_journey(g, entries, "patched")
                return fresh
            fresh = cached.with_fresh_params()
            if entries is not None:
                _note_planes_journey(g, entries, "fresh")
            return fresh
        return cached

    # -- query-side helpers ----------------------------------------------

    def edges_of_channel(self, chan_index: int) -> np.ndarray:
        """Edge indices (<= 2) carrying channel `chan_index`."""
        lo = np.searchsorted(self._chan_sorted, chan_index, "left")
        hi = np.searchsorted(self._chan_sorted, chan_index, "right")
        return self._chan_order[lo:hi]

    def edge_ok_mask(self, excluded_scids=None) -> np.ndarray:
        """(e_pad,) bool: enabled minus the query's exclusions.  Unknown
        scids are ignored, matching dijkstra's set-membership check."""
        mask = self.edge_enabled
        if excluded_scids:
            mask = mask.copy()
            for scid in excluded_scids:
                try:
                    c = self.g.channel_index(int(scid))
                except KeyError:
                    continue
                mask[self.edges_of_channel(c)] = False
        return mask
