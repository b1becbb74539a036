"""Min-cost-flow routing: the askrene/renepay-class payment solver
(the port's copy of the host oracle; numpy, no device).

After Core Lightning's plugins/askrene/ (getroutes with layers, biases
and reservations; mcf.c, flow.c, refine.c) and plugins/renepay's
Pickhardt-payments model (probabilistic channel capacities,
piecewise-linear cost, multi-part decomposition), written array-first:
arcs live in flat numpy arrays derived from the gossmap SoA, and the
solver is successive shortest paths whose relaxation step is an
edge-parallel Bellman-Ford sweep (one vectorized scatter-min over all
residual arcs a round).  routing/mcf_device.py runs the same solve on
the card (kernel R2) and is held against this module.

Cost model (renepay mcf.c semantics, re-derived):
  - fee cost: fee_ppm + base_fee amortized over the expected part size,
    in ppm of the routed amount;
  - reliability cost: P(success) for sending x over capacity c is
    (c+1-x)/(c+1) under a uniform prior; -log P is convexified into
    NUM_PIECES linear pieces, each capacity c/NUM_PIECES with slope
    PIECE_SLOPES[i] * prob_weight;
  - delay cost: cltv_delta * delay_weight ppm;
  - per-channel bias from layers (askrene bias semantics).

askrene's RPC surface (``attach_routing_commands`` in the JAX package)
is not here yet: it waits for the port's daemon.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

import numpy as np

from ..gossip.gossmap import Gossmap
from .dijkstra import NoRoute, RouteHop, hop_fee_msat

log = logging.getLogger("lightning_tpu_torch.routing.mcf")


class _WarnOnce:
    """Thread-safe once-latch for the MAX_ROUNDS truncation warning.
    The solver runs from coalesced McfService worker threads as well as
    inline RPC handlers; a bare check-then-set module global could emit
    the WARNING from several racing threads (or never latch at all)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fired = False

    def first(self) -> bool:
        """True exactly once per process (until reset)."""
        with self._lock:
            fired, self._fired = self._fired, True
            return not fired

    def reset(self) -> None:
        with self._lock:
            self._fired = False


_warned_rounds = _WarnOnce()

NUM_PIECES = 4
# slopes of the convex piecewise -log((c+1-x)/(c+1)) approximation,
# one per quarter of capacity (steeper as the channel saturates)
PIECE_SLOPES = (1.0, 3.0, 9.0, 27.0)
MAX_PARTS = 16
MAX_ROUNDS = 40          # Bellman-Ford sweeps per shortest-path solve


class McfError(NoRoute):
    pass


@dataclass
class Layers:
    """askrene's layer/bias/reservation state, flattened.

    disabled: scids whose both directions are unusable
    biases:   scid -> ppm-equivalent additive cost (negative = prefer)
    reserved: (scid, direction) -> msat currently held by in-flight
              payments (reduces usable capacity, reserve.c semantics)
    """
    disabled: set = field(default_factory=set)
    biases: dict = field(default_factory=dict)
    reserved: dict = field(default_factory=dict)
    # askrene-inform-channel constraints: observed liquidity bounds
    # (askrene/reserve.c constraint semantics): (scid, dir) ->
    # {"max": msat|None, "min": msat|None, "ts": unix}.  `max` caps the
    # usable capacity (a payment of max+1 failed there); `min` is
    # advisory knowledge that at least that much passed.
    knowledge: dict = field(default_factory=dict)
    # askrene-create-channel: scid -> {"source": bytes(33),
    # "destination": bytes(33), "capacity_sat": int}.  Created channels
    # route only in directions that also carry an update (the
    # reference's create-then-update flow, askrene/layer.c).
    created: dict = field(default_factory=dict)
    # askrene-update-channel: (scid, dir) -> overrides {enabled,
    # fee_base_msat, fee_proportional_millionths, cltv_expiry_delta,
    # htlc_minimum_msat, htlc_maximum_msat}
    updates: dict = field(default_factory=dict)
    # askrene-disable-node / askrene-bias-node: node_id bytes keys
    disabled_nodes: set = field(default_factory=set)
    node_biases: dict = field(default_factory=dict)

    def inform(self, scid: int, direction: int, *,
               max_msat: int | None = None, min_msat: int | None = None,
               ts: float | None = None) -> None:
        import time as _t

        k = self.knowledge.setdefault(
            (scid, direction), {"max": None, "min": None, "ts": 0})
        if max_msat is not None:
            k["max"] = max_msat if k["max"] is None \
                else min(k["max"], max_msat)
        if min_msat is not None:
            k["min"] = min_msat if k["min"] is None \
                else max(k["min"], min_msat)
        k["ts"] = ts if ts is not None else _t.time()

    def age(self, cutoff_ts: float) -> int:
        """Drop constraints learned before cutoff (askrene-age)."""
        old = [k for k, v in self.knowledge.items()
               if v["ts"] < cutoff_ts]
        for k in old:
            del self.knowledge[k]
        return len(old)

    def reserve(self, scid: int, direction: int, amount_msat: int) -> None:
        key = (scid, direction)
        self.reserved[key] = self.reserved.get(key, 0) + amount_msat

    def unreserve(self, scid: int, direction: int, amount_msat: int) -> None:
        key = (scid, direction)
        left = self.reserved.get(key, 0) - amount_msat
        if left > 0:
            self.reserved[key] = left
        else:
            self.reserved.pop(key, None)


@dataclass
class _LayeredGossmap(Gossmap):
    """A Gossmap with layer-created channels appended.  The base node
    table stays sorted (searchsorted still works on the prefix); nodes
    that exist only in layer-created channels resolve through
    extra_nodes."""
    base_nodes: int = 0
    extra_nodes: dict = field(default_factory=dict)  # node_id -> index

    def node_index(self, node_id: bytes) -> int:
        ids = self.node_ids[:self.base_nodes].view(
            [("k", "V33")]).reshape(-1)
        key = np.frombuffer(node_id, np.uint8).view([("k", "V33")])
        i = np.searchsorted(ids, key[0])
        if i < len(ids) and ids[i] == key[0]:
            return int(i)
        if node_id in self.extra_nodes:
            return self.extra_nodes[node_id]
        raise KeyError(f"unknown node {node_id.hex()[:16]}")


def graph_with_layers(g: Gossmap, layers: Layers | None) -> Gossmap:
    """Materialize layer-created channels and per-direction channel
    updates into a solver-ready graph (askrene/layer.c
    add_layer_channel / layer_update_channel semantics).  Returns g
    unchanged when the layers carry neither.

    Materialization copies every per-channel array (O(C)), so results
    are memoized ON the base graph keyed by the layer content — the
    common one-layer-per-payment-attempt pattern pays the copy once,
    and the cache dies with g."""
    if layers is None or not (layers.created or layers.updates):
        return g
    sig = (
        tuple(sorted((s, c["source"], c["destination"],
                      c["capacity_sat"])
                     for s, c in layers.created.items())),
        tuple(sorted(
            (k, tuple(sorted((n, v) for n, v in u.items()
                             if v is not None)))
            for k, u in layers.updates.items())),
    )
    cache = g.__dict__.setdefault("_layer_graph_cache", {})
    hit = cache.get(sig)
    if hit is not None:
        return hit

    extra: dict[bytes, int] = {}
    new_ids: list[np.ndarray] = []

    def _idx(nid: bytes) -> int:
        try:
            return g.node_index(nid)
        except KeyError:
            if nid not in extra:
                extra[nid] = g.n_nodes + len(new_ids)
                new_ids.append(np.frombuffer(nid, np.uint8))
            return extra[nid]

    created = sorted(layers.created.items())
    n1 = [_idx(c["source"]) for _, c in created]
    n2 = [_idx(c["destination"]) for _, c in created]
    Cn = len(created)

    node_ids = (np.concatenate([g.node_ids, np.stack(new_ids)])
                if new_ids else g.node_ids)
    scids = np.concatenate(
        [g.scids, np.array([s for s, _ in created], np.uint64)])
    node1 = np.concatenate([g.node1, np.array(n1, np.int32)])
    node2 = np.concatenate([g.node2, np.array(n2, np.int32)])
    capacity = np.concatenate(
        [g.capacity_sat,
         np.array([c["capacity_sat"] for _, c in created], np.float32)])

    def _ext(arr, fill):
        pad = np.full((2, Cn), fill, arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    # created directions start disabled: only an update makes them
    # routable (fees/limits come from that update)
    enabled = _ext(g.enabled, False)
    cltv = _ext(g.cltv_delta, 6)
    hmin = _ext(g.htlc_min_msat, 0)
    hmax = _ext(g.htlc_max_msat, 0)
    fbase = _ext(g.fee_base_msat, 0)
    fppm = _ext(g.fee_ppm, 0)
    ts = _ext(g.timestamps, 0)

    pos = {int(s): g.n_channels + i for i, (s, _) in enumerate(created)}
    for (scid, d), u in layers.updates.items():
        p = pos.get(int(scid))
        if p is None:
            try:
                p = g.channel_index(int(scid))
            except KeyError:
                continue             # update names no known channel
        enabled[d, p] = u.get("enabled", True)
        for key, arr in (("fee_base_msat", fbase),
                         ("fee_proportional_millionths", fppm),
                         ("cltv_expiry_delta", cltv),
                         ("htlc_minimum_msat", hmin),
                         ("htlc_maximum_msat", hmax)):
            if u.get(key) is not None:
                arr[d, p] = u[key]

    built = _LayeredGossmap(
        node_ids=node_ids, scids=scids, node1=node1, node2=node2,
        capacity_sat=capacity, enabled=enabled, cltv_delta=cltv,
        htlc_min_msat=hmin, htlc_max_msat=hmax, fee_base_msat=fbase,
        fee_ppm=fppm, timestamps=ts,
        base_nodes=g.n_nodes, extra_nodes=extra)
    if len(cache) >= 8:            # bound: distinct layer combos rare
        cache.clear()
    cache[sig] = built
    return built


@dataclass
class Arcs:
    """Residual-graph arcs, one row per (channel-direction × piece),
    plus paired reverse arcs at odd indices (arc i ^ 1 = its reverse)."""
    src: np.ndarray          # (A,) int32
    dst: np.ndarray          # (A,) int32
    residual: np.ndarray     # (A,) int64 msat
    cost_ppm: np.ndarray     # (A,) float64 cost per msat
    chan: np.ndarray         # (A,) int32 channel index (-1 for reverse)
    cdir: np.ndarray         # (A,) int8 channel direction


def build_arcs(g: Gossmap, amount_msat: int, layers: Layers | None = None,
               prob_weight: float = 1.0, delay_weight: float = 1.0,
               part_hint: int | None = None) -> Arcs:
    """Linearize every enabled channel direction into NUM_PIECES arcs
    with capacities and per-msat costs, interleaved with zero-capacity
    reverse arcs (residual graph, forward arc 2k, reverse 2k+1)."""
    layers = layers or Layers()
    C = g.n_channels
    part = max(1, amount_msat // (part_hint or MAX_PARTS))

    srcs, dsts, caps, costs, chans, cdirs = [], [], [], [], [], []
    cap_msat_all = (g.capacity_sat.astype(np.float64) * 1000).astype(np.int64)
    for d in (0, 1):
        en = g.enabled[d].copy()
        # a channel demanding HTLCs bigger than our expected part size
        # can't carry any part (renepay disables such channels up front)
        en &= g.htlc_min_msat[d].astype(np.int64) <= part
        if layers.disabled:
            dis = np.fromiter((int(s) in layers.disabled for s in g.scids),
                              bool, C)
            en &= ~dis
        if layers.disabled_nodes:
            bad = []
            for nid in layers.disabled_nodes:
                try:
                    bad.append(g.node_index(nid))
                except KeyError:
                    pass
            if bad:
                u_all = g.node1 if d == 0 else g.node2
                v_all = g.node2 if d == 0 else g.node1
                en &= ~(np.isin(u_all, bad) | np.isin(v_all, bad))
        idx = np.nonzero(en)[0]
        if len(idx) == 0:
            continue
        # direction d carries from node_{d+1} to node_{2-d}: in gossmap,
        # dir 0 is node1->node2 (update signed by node1)
        u = (g.node1 if d == 0 else g.node2)[idx]
        v = (g.node2 if d == 0 else g.node1)[idx]
        cap = cap_msat_all[idx].copy()
        hmax = g.htlc_max_msat[d, idx].astype(np.int64)
        # unknown on-chain capacity (no UTXO amount in the store): the
        # direction's htlc_maximum is the best bound we have
        unknown = cap == 0
        cap[unknown] = hmax[unknown]
        has_max = hmax > 0
        cap[has_max] = np.minimum(cap[has_max], hmax[has_max])
        cap[cap == 0] = amount_msat          # no bound at all: permissive
        if layers.reserved:
            res = np.fromiter(
                (layers.reserved.get((int(s), d), 0) for s in g.scids[idx]),
                np.int64, len(idx))
            cap = np.maximum(cap - res, 0)
        if layers.knowledge:
            def _kmax(s):
                k = layers.knowledge.get((int(s), d))
                m = None if k is None else k.get("max")
                return (1 << 62) if m is None else m   # 0 IS a constraint

            kmax = np.fromiter((_kmax(s) for s in g.scids[idx]),
                               np.int64, len(idx))
            cap = np.minimum(cap, kmax)

        fee_ppm = g.fee_ppm[d, idx].astype(np.float64)
        base = g.fee_base_msat[d, idx].astype(np.float64)
        eff_ppm = fee_ppm + base * 1e6 / part
        eff_ppm += g.cltv_delta[d, idx].astype(np.float64) * delay_weight
        if layers.biases:
            bias = np.fromiter(
                (layers.biases.get(int(s), 0) for s in g.scids[idx]),
                np.float64, len(idx))
            eff_ppm += bias
        if layers.node_biases:
            nb = np.zeros(g.n_nodes)
            for nid, b in layers.node_biases.items():
                try:
                    nb[g.node_index(nid)] = b
                except KeyError:
                    pass
            eff_ppm += nb[u]         # bias rides on the node's channels

        # piece capacities sum EXACTLY to cap: a reserved-to-zero or
        # tiny direction must not leak phantom capacity (the last piece
        # carries the remainder, earlier pieces may be 0 and are culled)
        piece_cap = cap // NUM_PIECES
        # probability slope scaled so a full channel costs ~prob_weight
        # ppm-equivalents per msat at the steep end
        for p in range(NUM_PIECES):
            pc = piece_cap if p < NUM_PIECES - 1 else cap - piece_cap * (
                NUM_PIECES - 1)
            prob_ppm = PIECE_SLOPES[p] * prob_weight * 1e6 / np.maximum(
                cap.astype(np.float64), 1.0)
            usable = pc > 0
            srcs.append(u[usable])
            dsts.append(v[usable])
            caps.append(pc[usable])
            costs.append((eff_ppm + prob_ppm * part)[usable])
            chans.append(idx[usable])
            cdirs.append(np.full(usable.sum(), d, np.int8))

    if not srcs:
        raise McfError("no usable channels")
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    cap = np.concatenate(caps).astype(np.int64)
    cost = np.concatenate(costs)
    chan = np.concatenate(chans).astype(np.int32)
    cdir = np.concatenate(cdirs)

    A = len(src)
    # interleave forward/reverse: arc 2k forward, 2k+1 its reverse
    i_src = np.empty(2 * A, np.int32)
    i_dst = np.empty(2 * A, np.int32)
    i_res = np.zeros(2 * A, np.int64)
    i_cost = np.empty(2 * A, np.float64)
    i_chan = np.full(2 * A, -1, np.int32)
    i_cdir = np.zeros(2 * A, np.int8)
    i_src[0::2], i_src[1::2] = src, dst
    i_dst[0::2], i_dst[1::2] = dst, src
    i_res[0::2] = cap
    i_cost[0::2], i_cost[1::2] = cost, -cost
    i_chan[0::2] = chan
    i_chan[1::2] = chan
    i_cdir[0::2] = cdir
    i_cdir[1::2] = cdir
    return Arcs(i_src, i_dst, i_res, i_cost, i_chan, i_cdir)


def _shortest_path(arcs: Arcs, n_nodes: int, src: int, dst: int):
    """Edge-parallel Bellman–Ford over live residual arcs.  Returns
    (pred_arc per node or None).  Each round is one vectorized
    relaxation of every arc — the TPU-friendly fixed-shape sweep."""
    live = np.nonzero(arcs.residual > 0)[0]
    if len(live) == 0:
        return None
    a_src = arcs.src[live]
    a_dst = arcs.dst[live]
    a_cost = arcs.cost_ppm[live]

    dist = np.full(n_nodes, np.inf)
    pred = np.full(n_nodes, -1, np.int64)
    dist[src] = 0.0
    converged = False
    for _ in range(MAX_ROUNDS):
        cand = dist[a_src] + a_cost
        better = cand < dist[a_dst] - 1e-9
        if not better.any():
            converged = True
            break
        # scatter-min: lowest candidate per destination wins this round
        b_dst = a_dst[better]
        b_cand = cand[better]
        b_arc = live[better]
        order = np.argsort(b_cand, kind="stable")
        b_dst, b_cand, b_arc = b_dst[order], b_cand[order], b_arc[order]
        first = np.unique(b_dst, return_index=True)[1]
        upd = b_cand[first] < dist[b_dst[first]] - 1e-9
        dist[b_dst[first][upd]] = b_cand[first][upd]
        pred[b_dst[first][upd]] = b_arc[first][upd]
    if not converged:
        # the round cap truncated convergence: routes can be suboptimal
        # (never incorrect — dist only improves).  The reference benches
        # exactly this on 1M-channel graphs; don't hide the cap — but
        # warn once (solve() calls this up to 4*max_parts times per
        # payment; a warning per sweep would flood the routing hot loop)
        level = logging.WARNING if _warned_rounds.first() else logging.DEBUG
        log.log(level, "bellman-ford hit MAX_ROUNDS=%d before convergence "
                "(%d nodes, %d arcs): path may be suboptimal",
                MAX_ROUNDS, n_nodes, len(a_src))
    if not np.isfinite(dist[dst]):
        return None
    return pred


def solve(g: Gossmap, source: bytes, destination: bytes, amount_msat: int,
          layers: Layers | None = None, prob_weight: float = 1.0,
          delay_weight: float = 1.0, max_parts: int = MAX_PARTS):
    """Route amount_msat via min-cost flow.  Returns a list of
    (channel_path, amount) where channel_path is [(chan_idx, dir), ...]
    in forward order — the flow decomposition renepay feeds to its
    routebuilder."""
    src = g.node_index(source)
    dst = g.node_index(destination)
    if src == dst:
        raise McfError("source is destination")
    arcs = build_arcs(g, amount_msat, layers, prob_weight, delay_weight,
                      part_hint=max_parts)

    remaining = amount_msat
    for _ in range(4 * max_parts):
        if remaining <= 0:
            break
        pred = _shortest_path(arcs, g.n_nodes, src, dst)
        if pred is None:
            raise McfError(
                f"no residual path for remaining {remaining} msat")
        # walk dst → src along predecessor arcs (cycle guard: a
        # MAX_ROUNDS-truncated BF on a residual graph with negative
        # reverse arcs can leave a cyclic pred — fail loudly, never spin)
        path = []
        v = dst
        seen = set()
        bottleneck = remaining
        while v != src:
            if v in seen:
                raise McfError("predecessor cycle (solver truncation)")
            seen.add(v)
            a = int(pred[v])
            path.append(a)
            bottleneck = min(bottleneck, int(arcs.residual[a]))
            v = int(arcs.src[a])
        for a in path:
            arcs.residual[a] -= bottleneck
            arcs.residual[a ^ 1] += bottleneck   # open the reverse arc
        remaining -= bottleneck
    if remaining > 0:
        raise McfError(f"could not place {remaining} msat")

    return _decompose(g, arcs, src, dst, amount_msat)


def flow_from_arcs(arcs: Arcs) -> dict:
    """Net flow per (channel, direction) from a solved residual graph:
    each forward arc's reverse residual is the flow pushed through it.
    Insertion order follows ascending arc index: peel_parts tie-breaks
    depend on it, so the device solver rebuilds the SAME order from its
    canonical arc layout (routing/mcf_device.py)."""
    flow: dict[tuple[int, int], int] = {}
    fwd = np.arange(0, len(arcs.src), 2)
    used = fwd[arcs.residual[fwd + 1] > 0]   # reverse residual = flow
    for a in used:
        key = (int(arcs.chan[a]), int(arcs.cdir[a]))
        flow[key] = flow.get(key, 0) + int(arcs.residual[a + 1])
    return flow


def peel_parts(g: Gossmap, flow: dict, src: int, dst: int,
               amount_msat: int):
    """Peel source→dest paths off a per-(chan,dir) flow map (renepay
    flow decomposition).  Deterministic given `flow` and its insertion
    order: the widest-first edge choice breaks ties on list position,
    i.e. on the order flow_from_arcs inserted the channels."""
    # adjacency from flow edges
    out: dict[int, list] = {}
    for (c, d), f in flow.items():
        if f <= 0:
            continue
        u = int((g.node1 if d == 0 else g.node2)[c])
        v = int((g.node2 if d == 0 else g.node1)[c])
        out.setdefault(u, []).append([v, c, d, f])

    parts = []
    placed = 0
    while placed < amount_msat:
        # walk a positive-flow path src → dst
        path, v, seen = [], src, set()
        bottleneck = amount_msat - placed
        while v != dst:
            edges = [e for e in out.get(v, []) if e[3] > 0]
            if not edges or v in seen:
                raise McfDecompositionError(v)
            seen.add(v)
            e = max(edges, key=lambda e: e[3])
            path.append(e)
            bottleneck = min(bottleneck, e[3])
            v = e[0]
        for e in path:
            e[3] -= bottleneck
        parts.append(([(c, d) for _, c, d, _ in path], bottleneck))
        placed += bottleneck
    return parts


def _decompose(g: Gossmap, arcs: Arcs, src: int, dst: int,
               amount_msat: int):
    """Net out per channel-direction flow, then peel source→dest paths
    (renepay flow decomposition)."""
    return peel_parts(g, flow_from_arcs(arcs), src, dst, amount_msat)


class McfDecompositionError(McfError):
    """Flow conservation violated — a solver bug, not a routing miss.
    An McfError (NOT AssertionError): decomposition failures must stay
    distinguishable from strippable asserts — under ``python -O`` an
    AssertionError subclass still raises, but anything treating it as
    an assertion-class invariant would conflate a real conservation bug
    with debug-only checks (tests/test_zz_mcf_parity.py pins -O)."""

    def __init__(self, node: int):
        super().__init__(f"flow stuck at node {node}")


def routes_from_parts(g: Gossmap, parts, destination: bytes,
                      final_cltv: int = 18):
    """Turn flow parts into wire-ready routes: per part, accumulate
    fees/delays backward from the destination exactly like getroute
    (each hop's amount is what the NEXT node must receive)."""
    routes = []
    for chan_path, amount in parts:
        hops = []
        amt = amount
        delay = final_cltv
        for c, d in reversed(chan_path):
            v = int((g.node2 if d == 0 else g.node1)[c])
            hops.append(RouteHop(
                node_id=bytes(g.node_ids[v]), scid=int(g.scids[c]),
                direction=d, amount_msat=amt, delay=delay))
            amt += hop_fee_msat(int(g.fee_base_msat[d, c]),
                                int(g.fee_ppm[d, c]), amt)
            delay += int(g.cltv_delta[d, c])
        hops.reverse()
        routes.append({
            "amount_msat": amount,
            "amount_sent_msat": hops[0].amount_msat if hops else amount,
            # what the SOURCE node itself must be handed to forward this
            # part (its own fee/delta included) — the number a payer one
            # unannounced hop before `source` needs (xpay prepend)
            "source_amount_msat": amt,
            "source_delay": delay,
            "final_cltv": final_cltv,
            "path": hops,
        })
    return routes


def getroutes(g: Gossmap, source: bytes, destination: bytes,
              amount_msat: int, layers: Layers | None = None,
              maxfee_msat: int | None = None, final_cltv: int = 18,
              prob_weight: float = 1.0, delay_weight: float = 1.0,
              max_parts: int = MAX_PARTS) -> dict:
    """askrene's getroutes shape: multi-part routes + total fee, with
    the maxfee constraint enforced on the SOLUTION.  If the first solve
    blows the budget we re-solve with the reliability weight slashed so
    fees dominate the objective (the direction askrene's refine step
    moves its fee-weight mu)."""
    g = graph_with_layers(g, layers)
    for attempt_prob in (prob_weight, prob_weight / 100.0):
        parts = solve(g, source, destination, amount_msat, layers,
                      attempt_prob, delay_weight, max_parts)
        routes = routes_from_parts(g, parts, destination, final_cltv)
        fee = sum(r["path"][0].amount_msat for r in routes) - amount_msat
        if maxfee_msat is None or fee <= maxfee_msat:
            return {"routes": [_route_rpc(r) for r in routes],
                    "fee_msat": fee, "parts": len(routes)}
    raise McfError(f"cheapest multi-part fee {fee} exceeds maxfee "
                   f"{maxfee_msat}")


def _route_rpc(r: dict) -> dict:
    return {
        "amount_msat": r["amount_msat"],
        "source_amount_msat": r["source_amount_msat"],
        "source_delay": r["source_delay"],
        "final_cltv": r["final_cltv"],
        "path": [{
            "short_channel_id": h.scid, "direction": h.direction,
            "next_node_id": h.node_id.hex(), "amount_msat": h.amount_msat,
            "delay": h.delay,
        } for h in r["path"]],
    }
