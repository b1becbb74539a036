"""Device-batched min-cost flow: the askrene/renepay payment engine as a
batched successive-shortest-paths solve on the card (kernel R2,
routing/csrc/mcf_ssp.cu), plus the McfService micro-batching front-end.

The host solver (routing/mcf.py) relaxes with an edge-parallel
Bellman-Ford sweep over every residual arc; here the same solve runs
over the same residual-arc universe for Q concurrent getroutes queries
in one kernel launch.

Arc universe: every (direction, piece, channel) triple is one forward
arc in CANONICAL order (direction-major, then the NUM_PIECES
piecewise-linear cost lanes, then channel index ascending), interleaved
with its reverse arc (forward 2k, reverse 2k + 1), exactly the layout
``mcf.build_arcs`` emits minus the per-query culling (unusable lanes
carry zero residual).  Canonical order is load-bearing: both solvers
break equal-cost relaxation ties on LOWEST arc index, and the flow
decomposition breaks ties on flow-map insertion order, so identical arc
order + identical float64 cost lanes + identical int64 capacities give
byte-identical route-part sets.

Per-query cost and capacity lanes are derived on the host (numpy, in the
dispatch worker) with bit-for-bit the arithmetic of ``mcf.build_arcs``;
the augmentations run on the card; flow decomposition and fee accounting
return to the host (they are O(parts), not O(arcs)).  Lanes, decomposition
and fees all read the planes' copy of the map's parameters
(``McfPlanes.view``), so a channel_update landing mid-solve cannot tear
an answer: it is that of the revision solved.

Host answers are part of the exactness contract and nothing else: a
query the planes cannot express (layer-created channels or per-direction
layer updates: a different topology; amounts past 2^48; max_parts past
the augmentation budget) or whose answer could not be proven (walk cap,
decomposition mismatch) is answered by the host oracle
``mcf.getroutes``, counted by reason in ``clntpu_mcf_fallback_total``.
McfService's flushes are supervised as routing/device.py's are (the
"mcf" family, the same outcome mapping): an open breaker, a blown
deadline or a dispatch error fails the flush's device queries, and
nothing is re-solved on the host for them.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as D
from ..obs import attribution as _attr
from ..obs import families as _families
from ..obs import journey as _journey
from ..resilience import deadline as _deadline
from ..resilience import overload as _overload
from ..resilience import quarantine as _quarantine
from ..utils import trace
from . import hopper_route as HR
from . import mcf as MCF
from .device import FlushService

log = logging.getLogger("lightning_tpu_torch.routing.mcf_device")

# canonical-universe constants (shared with the host solver)
NUM_PIECES = MCF.NUM_PIECES
MAX_ROUNDS = MCF.MAX_ROUNDS
# augmentation budget of a solve: a query's own cap is 4 * max_parts
# (host semantics); max_parts beyond MCF.MAX_PARTS goes to the host
AUG_STEPS = 4 * MCF.MAX_PARTS
WALK_CAP = HR.WALK_CAP

_MIN_NODE_PAD = 64
_MIN_ARC_PAD = 256

MCF_BATCH = 8               # device query bucket
MCF_FLUSH_MS = 3.0          # flush latency budget
# int64 residual/remaining headroom: piece capacities can carry the "no
# bound at all" amount fill, and augmentation adds bottlenecks into
# reverse lanes; 2^48 msat (~2814 BTC) keeps every sum far below 2^62
MCF_MAX_AMOUNT_MSAT = 1 << 48
# admission-control high watermark in queued QUERIES (the low one is
# half of it): an MCF solve is about an order heavier than a getroute,
# so it sits below the route one
MCF_HIGH_WM = 64

# host-answer reasons
R_AMOUNT_CAP = "amount_cap"
R_MAX_PARTS = "max_parts_cap"
R_LAYERED = "layered_topology"
R_WALK_CAP = "walk_cap"
R_DECOMPOSE = "decompose"

PIECE_SLOPES_F64 = tuple(float(s) for s in MCF.PIECE_SLOPES)


# ---------------------------------------------------------------------------
# McfPlanes: the canonical arc universe + cached per-direction lanes


@dataclass
class _DirLanes:
    """Per-direction channel-major parameter lanes (the inputs
    mcf.build_arcs reads), cached as the dtypes it converts to.  Copies,
    not views: a freshness bump re-derives them; in-place gossmap
    updates between bumps cannot tear a prep."""

    u: np.ndarray          # (C,) int32: forwarding node
    v: np.ndarray          # (C,) int32: receiving node
    enabled: np.ndarray    # (C,) bool
    hmin: np.ndarray       # (C,) int64
    cap0: np.ndarray       # (C,) int64: capacity after the hmax fold
    fee_ppm: np.ndarray    # (C,) float64
    base: np.ndarray       # (C,) float64
    cltv: np.ndarray       # (C,) float64


# the Gossmap arrays a channel_update writes in place
# (Gossmap.apply_channel_update); its topology arrays never change in place
_PARAM_FIELDS = ("timestamps", "enabled", "cltv_delta", "htlc_min_msat",
                 "htlc_max_msat", "fee_base_msat", "fee_ppm")


def _revision_view(g):
    """``g`` as of now: the topology arrays shared, the parameter arrays
    copied, so that later channel_updates to ``g`` leave it as it is."""
    return dataclasses.replace(
        g, **{k: getattr(g, k).copy() for k in _PARAM_FIELDS})


def _pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


@dataclass
class McfPlanes:
    """One Gossmap revision's full (direction x piece x channel) arc
    universe in canonical order.

    The interleaved arc endpoints (``i_src``/``i_dst``) and R2's arcs by
    tail upload to ``device`` once per topology revision
    (``device_arcs``); the per-direction parameter lanes refresh on a
    params bump and feed the per-query lane prep, which stays on the host
    (it depends on the query: amount, part hint, layers).  ``view`` is
    the map as of the same params revision: the lanes derive from it and
    the flows are decomposed and priced against it, so an answer is that
    of one revision, whatever channel_updates land during a solve."""

    g: object              # the live map (identity and version checks)
    view: object           # the map as of params_version
    topo_version: int
    params_version: int
    n_channels: int
    n_real: int
    n_pad: int
    a_fwd_real: int        # 2 * NUM_PIECES * n_channels
    a_fwd_pad: int
    i_src: np.ndarray      # (2*a_fwd_pad,) int32 (fwd 2k, rev 2k+1)
    i_dst: np.ndarray      # (2*a_fwd_pad,) int32
    dirs: tuple            # (_DirLanes, _DirLanes)
    # the map's change-log position at params_version (the journey's
    # mcf_planes hop names the updates a refresh picked up)
    params_log_pos: int = 0
    device: torch.device = torch.device("cpu")
    dev: dict = field(default_factory=dict)

    @classmethod
    def build(cls, g, device=None) -> "McfPlanes":
        """Planes of `g` for `device` (the card unless device="cpu")."""
        dev = D.resolve(device)
        C = g.n_channels
        n_pad = _pow2(max(g.n_nodes, 1), _MIN_NODE_PAD)
        a_fwd_real = 2 * NUM_PIECES * C
        a_fwd_pad = _pow2(max(a_fwd_real, 1), _MIN_ARC_PAD)

        fwd_src = np.zeros(a_fwd_pad, np.int32)
        fwd_dst = np.zeros(a_fwd_pad, np.int32)
        for d in (0, 1):
            u = (g.node1 if d == 0 else g.node2).astype(np.int32)
            v = (g.node2 if d == 0 else g.node1).astype(np.int32)
            for p in range(NUM_PIECES):
                lane = (d * NUM_PIECES + p) * C
                fwd_src[lane:lane + C] = u
                fwd_dst[lane:lane + C] = v
        i_src = np.empty(2 * a_fwd_pad, np.int32)
        i_dst = np.empty(2 * a_fwd_pad, np.int32)
        i_src[0::2], i_src[1::2] = fwd_src, fwd_dst
        i_dst[0::2], i_dst[1::2] = fwd_dst, fwd_src

        view = _revision_view(g)
        return cls(
            g=g, view=view,
            topo_version=g.topology_version,
            params_version=g.params_version,
            n_channels=C, n_real=g.n_nodes, n_pad=n_pad,
            a_fwd_real=a_fwd_real, a_fwd_pad=a_fwd_pad,
            i_src=i_src, i_dst=i_dst,
            dirs=tuple(cls._dir_lanes(view, d) for d in (0, 1)),
            params_log_pos=g.param_log_pos,
            device=dev,
        )

    @staticmethod
    def _dir_lanes(g, d: int) -> _DirLanes:
        cap = (g.capacity_sat.astype(np.float64) * 1000).astype(np.int64)
        hmax = g.htlc_max_msat[d].astype(np.int64)
        # unknown on-chain capacity: the direction's htlc_maximum is the
        # best bound; a present htlc_maximum always caps (build_arcs)
        unknown = cap == 0
        cap[unknown] = hmax[unknown]
        has_max = hmax > 0
        cap[has_max] = np.minimum(cap[has_max], hmax[has_max])
        return _DirLanes(
            u=(g.node1 if d == 0 else g.node2).astype(np.int32),
            v=(g.node2 if d == 0 else g.node1).astype(np.int32),
            enabled=g.enabled[d].copy(),
            hmin=g.htlc_min_msat[d].astype(np.int64),
            cap0=cap,
            fee_ppm=g.fee_ppm[d].astype(np.float64),
            base=g.fee_base_msat[d].astype(np.float64),
            cltv=g.cltv_delta[d].astype(np.float64),
        )

    def with_fresh_params(self) -> "McfPlanes":
        """Param-bump refresh: re-derive the per-direction lanes from
        the same topology revision, carrying the arc endpoints (and
        their uploads) over unchanged."""
        view = _revision_view(self.g)
        return dataclasses.replace(
            self, view=view,
            params_version=self.g.params_version,
            params_log_pos=self.g.param_log_pos,
            dirs=tuple(self._dir_lanes(view, d) for d in (0, 1)),
            dev=dict(self.dev),
        )

    def device_arcs(self) -> tuple:
        """(i_src, i_dst, tail_off, tail_arc, tail_dst, tail_pos) on
        ``device``, R2's topology operands, uploaded, grouped by tail
        (``HR.tail_csr``) and put in tail order (``HR.tail_order``) at
        the first call of a topology revision.  The padding arcs past
        ``2 * a_fwd_real`` carry no residual and are left out of the
        grouping."""
        if "i_src" not in self.dev:
            for k in ("i_src", "i_dst"):
                self.dev[k] = torch.as_tensor(getattr(self, k),
                                              device=self.device)
            self.dev["tail_off"], self.dev["tail_arc"] = HR.tail_csr(
                self.dev["i_src"], 2 * self.a_fwd_real, self.n_pad)
            self.dev["tail_dst"], self.dev["tail_pos"] = HR.tail_order(
                self.dev["i_dst"], self.dev["tail_arc"])
        return tuple(self.dev[k] for k in ("i_src", "i_dst", "tail_off",
                                           "tail_arc", "tail_dst",
                                           "tail_pos"))

    @classmethod
    def current(cls, g, cached: "McfPlanes | None",
                device=None) -> "McfPlanes":
        """Freshness gate (RoutePlanes.current's shape): rebuild on a
        topology bump, a different map object or another device, refresh
        the parameter lanes on a params bump, reuse otherwise.  Never
        mutates ``cached``."""
        if (cached is None or cached.g is not g
                or cached.device != D.resolve(device)
                or cached.topo_version != g.topology_version):
            return cls.build(g, device)
        if cached.params_version != g.params_version:
            fresh = cached.with_fresh_params()
            if _journey.enabled():
                # journey terminus for the MCF view: the sampled
                # channel_update's parameters are now in the lanes the
                # next batched solve prices against
                entries = g.param_entries_since(cached.params_log_pos)
                if entries is not None:
                    for c, d in set(entries):
                        _journey.hop("mcf_planes", "channel",
                                     int(g.scids[int(c)]),
                                     outcome="fresh", direction=int(d))
            return fresh
        return cached


# ---------------------------------------------------------------------------
# Per-query cost/capacity lanes (bit-matching mcf.build_arcs)


def _knowledge_max(layers, scid: int, d: int) -> int:
    k = layers.knowledge.get((scid, d))
    m = None if k is None else k.get("max")
    return (1 << 62) if m is None else m   # 0 IS a constraint


def query_lanes(planes: McfPlanes, amount_msat: int, layers,
                prob_weight: float = 1.0, delay_weight: float = 1.0,
                part_hint: int | None = None):
    """The per-query (cost, capacity) lanes over the canonical forward
    arc universe: float64 per-msat costs and int64 piece capacities,
    value-identical to what ``mcf.build_arcs`` emits for the same query
    (unusable lanes carry zero capacity instead of being culled).

    Raises McfError("no usable channels") exactly when build_arcs
    would: when NO channel direction survives the enabled / hmin /
    disabled screens.  Enabled-but-zero-capacity universes (everything
    reserved, knowledge max=0) do NOT raise: build_arcs emits their
    empty piece arrays and the host solver answers "no residual path",
    so the kernel must see the zero-residual lanes and answer the
    same."""
    g = planes.g
    C = planes.n_channels
    layers = layers or MCF.Layers()
    part = max(1, amount_msat // (part_hint or MCF.MAX_PARTS))

    cost = np.zeros(planes.a_fwd_pad, np.float64)
    res = np.zeros(planes.a_fwd_pad, np.int64)
    if C == 0:
        raise MCF.McfError("no usable channels")

    dis = None
    if layers.disabled:
        dis = np.fromiter((int(s) in layers.disabled for s in g.scids),
                          bool, C)
    bad_nodes: list[int] = []
    for nid in layers.disabled_nodes:
        try:
            bad_nodes.append(g.node_index(nid))
        except KeyError:
            pass
    bias = None
    if layers.biases:
        bias = np.fromiter(
            (layers.biases.get(int(s), 0) for s in g.scids),
            np.float64, C)
    nb = None
    if layers.node_biases:
        nb = np.zeros(g.n_nodes)
        for nid, b in layers.node_biases.items():
            try:
                nb[g.node_index(nid)] = b
            except KeyError:
                pass

    any_enabled = False
    for d in (0, 1):
        lanes = planes.dirs[d]
        en = lanes.enabled & (lanes.hmin <= part)
        if dis is not None:
            en &= ~dis
        if bad_nodes:
            en &= ~(np.isin(lanes.u, bad_nodes)
                    | np.isin(lanes.v, bad_nodes))
        any_enabled = any_enabled or bool(np.any(en))
        cap = lanes.cap0.copy()
        cap[cap == 0] = amount_msat       # no bound at all: permissive
        if layers.reserved:
            rsv = np.fromiter(
                (layers.reserved.get((int(s), d), 0) for s in g.scids),
                np.int64, C)
            cap = np.maximum(cap - rsv, 0)
        if layers.knowledge:
            kmax = np.fromiter(
                (_knowledge_max(layers, int(s), d) for s in g.scids),
                np.int64, C)
            cap = np.minimum(cap, kmax)

        eff_ppm = lanes.fee_ppm + lanes.base * 1e6 / part
        eff_ppm = eff_ppm + lanes.cltv * delay_weight
        if bias is not None:
            eff_ppm = eff_ppm + bias
        if nb is not None:
            eff_ppm = eff_ppm + nb[lanes.u]

        piece_cap = cap // NUM_PIECES
        for p in range(NUM_PIECES):
            pc = piece_cap if p < NUM_PIECES - 1 \
                else cap - piece_cap * (NUM_PIECES - 1)
            prob_ppm = (PIECE_SLOPES_F64[p] * prob_weight * 1e6
                        / np.maximum(cap.astype(np.float64), 1.0))
            lane = (d * NUM_PIECES + p) * C
            res[lane:lane + C] = np.where(en & (pc > 0), pc, 0)
            cost[lane:lane + C] = eff_ppm + prob_ppm * part
    if not any_enabled:
        raise MCF.McfError("no usable channels")
    return cost, res


# ---------------------------------------------------------------------------
# Batched solve: prep -> dispatch -> decompose


def _freeze_layers(layers):
    """Value snapshot of a live mcf.Layers for the queue: lane prep runs
    in the flush worker thread while reservations and inform() may
    change the live object from the event loop, so a query solves
    against the layer state it was enqueued under.  Containers are
    copied (knowledge's inner dicts too); both the device prep and a
    host answer of the same query read this one copy."""
    if layers is None:
        return None
    return MCF.Layers(
        disabled=set(layers.disabled),
        biases=dict(layers.biases),
        reserved=dict(layers.reserved),
        knowledge={k: dict(v) for k, v in layers.knowledge.items()},
        created=dict(layers.created),
        updates=dict(layers.updates),
        disabled_nodes=set(layers.disabled_nodes),
        node_biases=dict(layers.node_biases),
    )


@dataclass
class McfQuery:
    """One getroutes-class request (mcf.getroutes semantics); ``layers``
    is the merged layer set the query solves against."""

    source: bytes
    destination: bytes
    amount_msat: int
    layers: object = None              # mcf.Layers | None
    maxfee_msat: int | None = None
    final_cltv: int = 18
    max_parts: int = MCF.MAX_PARTS
    prob_weight: float = 1.0
    delay_weight: float = 1.0
    future: object = None
    # the correlation carrier minted in the mcf/enqueue span, the
    # payment whose journey the query's hops join, and the enqueue time
    corr: object = None
    journey_key: object = None
    t_enq: float = 0.0


def _expressible(q: McfQuery) -> str | None:
    """None when the planes can express the query, else the reason the
    host answers it."""
    if not 0 < q.amount_msat <= MCF_MAX_AMOUNT_MSAT:
        return R_AMOUNT_CAP
    if not 0 < q.max_parts <= MCF.MAX_PARTS:
        return R_MAX_PARTS
    ly = q.layers
    if ly is not None and (ly.created or ly.updates):
        # layer-created channels / layer updates are a DIFFERENT
        # topology (graph_with_layers materializes a new gossmap)
        return R_LAYERED
    return None


def _decompose_flow(planes: McfPlanes, q: McfQuery,
                    flow_lanes: np.ndarray):
    """Flow decomposition from the kernel's per-forward-arc flows:
    rebuild the (channel, direction) flow map in canonical arc order
    (insertion order drives peel tie-breaks) and peel parts with the
    host solver's own code."""
    g = planes.view
    C = planes.n_channels
    used = np.nonzero(flow_lanes[:planes.a_fwd_real] > 0)[0]
    flow: dict[tuple[int, int], int] = {}
    for k in used:                      # ascending == canonical order
        c = int(k % C)
        d = int(k // C) // NUM_PIECES
        key = (c, d)
        flow[key] = flow.get(key, 0) + int(flow_lanes[k])
    src = g.node_index(q.source)
    dst = g.node_index(q.destination)
    return MCF.peel_parts(g, flow, src, dst, q.amount_msat)


def _finish_query(planes: McfPlanes, q: McfQuery,
                  flow_lanes: np.ndarray, remaining: int, nopath: bool,
                  walkfail: bool):
    """One query's resolution after readback.  Returns
    ("ok", result_dict) / ("mcferr", message) / ("fallback", reason) /
    ("retry", fee): retry = the fee budget blew and the host semantics
    call for a second solve with the reliability weight slashed."""
    if walkfail:
        return ("fallback", R_WALK_CAP)
    if nopath:
        # the host raises at the same remaining value (identical
        # residual evolution up to the failing augmentation)
        return ("mcferr",
                f"no residual path for remaining {remaining} msat")
    if remaining > 0:
        return ("mcferr", f"could not place {remaining} msat")
    try:
        parts = _decompose_flow(planes, q, flow_lanes)
        routes = MCF.routes_from_parts(planes.view, parts, q.destination,
                                       q.final_cltv)
    except Exception as e:
        log.warning("mcf flow decomposition diverged (%s); "
                    "the host answers", e)
        return ("fallback", R_DECOMPOSE)
    fee = sum(r["path"][0].amount_msat for r in routes) - q.amount_msat
    if q.maxfee_msat is not None and fee > q.maxfee_msat:
        return ("retry", fee)
    return ("ok", {"routes": [MCF._route_rpc(r) for r in routes],
                   "fee_msat": fee, "parts": len(routes)})


def _prep_chunk(planes: McfPlanes, chunk: list[McfQuery], batch: int,
                prob_scale: float, out: list):
    """Stage one padded dispatch's operands; resolves screening
    failures (unknown node, src == dst, dead universe, inexpressible)
    into ``out`` (chunk-indexed) and masks their lanes off."""
    cost = np.zeros((batch, planes.a_fwd_pad), np.float64)
    res = np.zeros((batch, planes.a_fwd_pad), np.int64)
    src = np.zeros(batch, np.int32)
    dst = np.zeros(batch, np.int32)
    amount = np.ones(batch, np.int64)
    aug_cap = np.zeros(batch, np.int32)
    g = planes.g
    for i, q in enumerate(chunk):
        reason = _expressible(q)
        if reason is not None:
            out[i] = ("fallback", reason)
            continue
        try:
            src[i] = g.node_index(q.source)
            dst[i] = g.node_index(q.destination)
        except KeyError as e:
            out[i] = ("error", e)
            continue
        if src[i] == dst[i]:
            out[i] = ("mcferr", "source is destination")
            continue
        try:
            cost[i], res[i] = query_lanes(
                planes, q.amount_msat, q.layers,
                q.prob_weight * prob_scale, q.delay_weight,
                part_hint=q.max_parts)
        except MCF.McfError as e:
            out[i] = ("mcferr", str(e))
            continue
        amount[i] = q.amount_msat
        aug_cap[i] = 4 * q.max_parts
    return cost, res, src, dst, amount, aug_cap


def _dispatch_lanes(planes: McfPlanes, ops: tuple,
                    io_acct: dict | None = None):
    """Upload the chunk's lanes (and, once per topology revision, the arc
    endpoints), run the batched solve (R2 on the card, its plain version
    on the CPU), read back the flows.  The staged bytes are counted in
    clntpu_transfer_bytes_total{family="mcf"} and added to ``io_acct``."""
    h2d = sum(a.nbytes for a in ops)
    if "i_src" not in planes.dev:
        h2d += planes.i_src.nbytes + planes.i_dst.nbytes
    _attr.note_program("mcf", (planes.n_pad, planes.a_fwd_pad,
                               ops[0].shape[0]))
    out = tuple(t.cpu().numpy() for t in HR.mcf_solve(
        *planes.device_arcs(),
        *(torch.as_tensor(a, device=planes.device) for a in ops),
        planes.n_pad))
    d2h = sum(a.nbytes for a in out)
    _families.TRANSFER_BYTES.labels("mcf", "h2d").inc(h2d)
    _families.TRANSFER_BYTES.labels("mcf", "d2h").inc(d2h)
    if io_acct is not None:
        io_acct["h2d_bytes"] = io_acct.get("h2d_bytes", 0) + h2d
        io_acct["d2h_bytes"] = io_acct.get("d2h_bytes", 0) + d2h
    return out


def _solve_indices(planes: McfPlanes, queries: list[McfQuery],
                   idx_list: list[int], batch: int, prob_scale: float,
                   out: list, io_acct: dict | None = None) -> list:
    """Prep + dispatch the named queries (blocking; runs in the flush
    worker).  Screening failures resolve straight into ``out``; device
    results come back as (index, flow_row, remaining, nopath, walkfail)
    readback tuples for the caller to judge."""
    readback: list = []
    for start in range(0, len(idx_list), batch):
        idxs = idx_list[start:start + batch]
        chunk = [queries[j] for j in idxs]
        sub: list = [None] * len(chunk)
        ops = _prep_chunk(planes, chunk, batch, prob_scale, sub)
        for i, j in enumerate(idxs):
            if sub[i] is not None:
                out[j] = sub[i]
        if all(r is not None for r in sub):
            continue
        flow, remaining, nopath, walkfail = _dispatch_lanes(planes, ops,
                                                            io_acct)
        for i, j in enumerate(idxs):
            if out[j] is None:
                readback.append((j, flow[i], int(remaining[i]),
                                 bool(nopath[i]), bool(walkfail[i])))
    return readback


def _judge_round(planes: McfPlanes, queries: list[McfQuery],
                 readback: list, out: list,
                 final_attempt: bool) -> list[int]:
    """Resolve one dispatch round's readbacks; returns the indices that
    blew their maxfee budget and earn the host's second attempt (the
    reliability weight slashed 100x).  On the final attempt a blown
    budget is the host's exact terminal McfError."""
    retry: list[int] = []
    for j, fl, rem, nop, wf in readback:
        verdict = _finish_query(planes, queries[j], fl, rem, nop, wf)
        if verdict[0] == "retry":
            if final_attempt:
                out[j] = ("mcferr",
                          f"cheapest multi-part fee {verdict[1]} "
                          f"exceeds maxfee {queries[j].maxfee_msat}")
            else:
                retry.append(j)
        else:
            out[j] = verdict
    return retry


def solve_mcf_batch(planes: McfPlanes, queries: list[McfQuery],
                    batch: int = MCF_BATCH,
                    io_acct: dict | None = None) -> list[tuple]:
    """Solve every query in ceil(Q / batch) dispatches on
    ``planes.device``, with host-side decomposition and the host's
    two-attempt maxfee semantics (a blown budget re-solves with the
    reliability weight slashed 100x before failing).

    Returns one tuple per query:
      ("ok", result_dict)   the mcf.getroutes response, exact
      ("mcferr", message)   unroutable (the host raises McfError here)
      ("fallback", reason)  the host oracle answers instead
      ("error", exc)        the query's own error (unknown node)
    """
    out: list = [None] * len(queries)
    rb = _solve_indices(planes, queries, list(range(len(queries))),
                        batch, 1.0, out, io_acct)
    retry = _judge_round(planes, queries, rb, out, final_attempt=False)
    if retry:
        rb2 = _solve_indices(planes, queries, retry, batch, 1.0 / 100.0,
                             out, io_acct)
        _judge_round(planes, queries, rb2, out, final_attempt=True)
    return out


# ---------------------------------------------------------------------------
# The micro-batching front-end


class McfService(FlushService):
    """Coalesce concurrent getroutes / xpay min-cost-flow queries into
    batched solves on the card, supervised as the "mcf" dispatch family
    (routing/device.py's ``FlushService``: breaker, fault seam, a
    deadline on each dispatch round, flight record, spans, the
    ``clntpu_mcf_*`` families).

    ``getroutes()`` is a drop-in awaitable for mcf.getroutes: same
    result dict, same McfError / KeyError behaviour."""

    FAMILY = "mcf"
    FLUSH_MS = MCF_FLUSH_MS
    BATCH = MCF_BATCH
    HIGH_WM = MCF_HIGH_WM
    M = {"flush_seconds": _families.MCF_FLUSH_SECONDS,
         "batch": _families.MCF_BATCH_QUERIES,
         "occupancy": _families.MCF_OCCUPANCY,
         "queries": _families.MCF_QUERIES,
         "fallback": _families.MCF_FALLBACK,
         "queue": _families.MCF_QUEUE}
    JOURNEY_STAGE = "mcf"

    async def getroutes(self, source: bytes, destination: bytes,
                        amount_msat: int, *, layers=None,
                        maxfee_msat: int | None = None,
                        final_cltv: int = 18,
                        max_parts: int = MCF.MAX_PARTS,
                        prob_weight: float = 1.0,
                        delay_weight: float = 1.0,
                        journey_key=None) -> dict:
        """``journey_key`` (a payment hash, optional) joins this query's
        pipeline hops to that payment's journey."""
        g = self.get_map()
        if g is None:
            raise MCF.McfError("no gossip graph loaded")
        with trace.span("mcf/enqueue"):
            corr = trace.new_corr()
            if journey_key is not None:
                _journey.hop("enqueue", "payment", journey_key,
                             outcome="ok", corr_id=corr.corr_id,
                             amount_msat=int(amount_msat))
            try:
                fut = self._admit()
            except _overload.Overloaded:
                if journey_key is not None:
                    _journey.hop("shed", "payment", journey_key,
                                 outcome="overload", reason="admission")
                raise
            q = McfQuery(
                source, destination, int(amount_msat),
                _freeze_layers(layers), maxfee_msat, int(final_cltv),
                int(max_parts), float(prob_weight), float(delay_weight),
                future=fut, corr=corr, journey_key=journey_key,
                t_enq=self.now())
            self._enqueue(q)
        return await q.future

    def _screen(self, batch: list[McfQuery]) -> tuple[list, list]:
        host: list[tuple[McfQuery, str]] = []
        device: list[McfQuery] = []
        for q in batch:
            reason = _expressible(q)
            if reason is not None:
                host.append((q, reason))
            else:
                device.append(q)
        return host, device

    async def _solve(self, g, device: list[McfQuery],
                     io_acct: dict) -> list:
        self._planes = McfPlanes.current(g, self._planes, self.device)
        planes = self._planes
        results: list = [None] * len(device)
        # lane prep and the solve run in the worker, judging
        # (decomposition and fees) back on the loop; both read the planes'
        # copy of the map's parameters, so the answers are those of the
        # revision solved, whatever channel_updates land meanwhile.  The
        # deadline bounds each round.
        todo = list(range(len(device)))
        for attempt, scale in enumerate((1.0, 1.0 / 100.0)):
            rb = await self._dispatch(
                _solve_indices, planes, device, todo, self.batch, scale,
                results, io_acct, first=attempt == 0)
            todo = _judge_round(planes, device, rb, results,
                                final_attempt=attempt == 1)
            if not todo:
                break
        return results

    def _fail_device(self, device: list, err: BaseException) -> None:
        if not isinstance(err, _deadline.DeadlineExceeded):
            # the JAX package counts a failed dispatch's rows as
            # quarantined (and re-solves them on the host)
            _quarantine.note("mcf", "dispatch", rows=len(device))
        super()._fail_device(device, err)

    def _no_graph(self) -> tuple:
        return ("mcferr", "no gossip graph loaded")

    def _host_solve(self, g, q: McfQuery) -> tuple:
        try:
            res = MCF.getroutes(
                g, q.source, q.destination, q.amount_msat,
                layers=q.layers, maxfee_msat=q.maxfee_msat,
                final_cltv=q.final_cltv, max_parts=q.max_parts,
                prob_weight=q.prob_weight,
                delay_weight=q.delay_weight)
            return ("ok", res)
        except MCF.McfError as e:
            return ("mcferr", str(e))
        except Exception as e:
            return ("error", e)

    def _resolve(self, q: McfQuery, path: str, res: tuple) -> None:
        fut = q.future
        if fut is None or fut.done():
            return
        if q.journey_key is not None:
            corr_id = q.corr.corr_id if q.corr else None
            ctx = self._flush_ctx
            if ctx is not None:
                # the batched-solve hop, before the parts hop, so the
                # journey reads in pipeline order (enqueue -> mcf_flush
                # -> parts)
                t_flush0, t_svc0, rec = ctx
                _journey.hop(
                    "mcf_flush", "payment", q.journey_key, outcome=path,
                    wait_s=max(0.0, t_flush0 - q.t_enq)
                    if q.t_enq else 0.0,
                    service_s=time.perf_counter() - t_svc0,
                    dispatch_id=rec["dispatch_id"], corr_id=corr_id)
            _journey.hop(
                "parts", "payment", q.journey_key, outcome=res[0],
                corr_id=corr_id, path=path,
                **({"parts": res[1]["parts"]} if res[0] == "ok" else {}))
        if res[0] == "ok":
            self.M["queries"].labels(path, "ok").inc()
            _families.MCF_PARTS.observe(res[1]["parts"])
            fut.set_result(res[1])
        elif res[0] == "mcferr":
            self.M["queries"].labels(path, "noroute").inc()
            fut.set_exception(MCF.McfError(res[1]))
        else:
            self.M["queries"].labels(path, "error").inc()
            err = res[1]
            fut.set_exception(err if isinstance(err, BaseException)
                              else RuntimeError(str(err)))
