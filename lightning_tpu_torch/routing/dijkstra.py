"""getroute: dijkstra over the gossmap with fee + risk costs (the
port's copy of the host oracle).

After Core Lightning's common/dijkstra.c and common/route.c (the cost
model) and plugins/topology.c (the getroute entry point).  Routing runs
BACKWARD from the destination, accumulating the amount each hop must
receive so compounding fees are exact.

Host-side numpy/heapq; the device solver (routing/device.py) sweeps
the same directed-edge universe and prices it with the same integer
cost model, so this is its exact oracle.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from ..gossip.gossmap import Gossmap

# CLN's default riskfactor: prices (amount × delay) lockup into msat
DEFAULT_RISKFACTOR = 10
BLOCKS_PER_YEAR = 52596


class NoRoute(Exception):
    pass


def noroute_msg(source: bytes, destination: bytes,
                amount_msat: int) -> str:
    """The one NoRoute message format, shared with the device solver
    (routing.device) so host and device answers for the same query
    never diverge."""
    return (f"no route {source.hex()[:8]} → {destination.hex()[:8]} "
            f"for {amount_msat} msat")


@dataclass
class RouteHop:
    """One forwarding step; mirrors the reference's getroute output:
    hop i forwards to node_id over scid, delivering amount_msat with
    `delay` blocks of cltv budget remaining at that node."""

    node_id: bytes
    scid: int
    direction: int
    amount_msat: int
    delay: int


def hop_fee_msat(base_msat: int, ppm: int, amount_msat: int) -> int:
    return base_msat + amount_msat * ppm // 1_000_000


def _risk_msat(amount_msat: int, delay: int, riskfactor: int) -> int:
    """CLN's risk pricing: amount × delay × rf / blocks-per-year."""
    return 1 + amount_msat * delay * riskfactor // (BLOCKS_PER_YEAR * 100)


def getroute(g: Gossmap, source: bytes, destination: bytes,
             amount_msat: int, final_cltv: int = 18,
             riskfactor: int = DEFAULT_RISKFACTOR,
             max_hops: int = 20,
             excluded_scids: set | None = None,
             with_source: bool = False):
    """Cheapest route source → destination delivering amount_msat.
    Returns hops in forward order, ready for onion construction.

    with_source=True additionally returns (amount_msat, delay) AT the
    source — what a payer one hop before `source` must deliver to it
    (used when our own unannounced channel feeds the public route)."""
    g.ensure_adjacency()   # fold any accepted first-direction updates
    src = g.node_index(source)
    dst = g.node_index(destination)
    if src == dst:
        raise NoRoute("source is destination")
    excluded_scids = excluded_scids or set()

    INF = float("inf")
    n = g.n_nodes
    dist = np.full(n, INF)
    amount = np.zeros(n, np.int64)  # msat that must ARRIVE at node
    delay = np.zeros(n, np.int32)  # cltv budget from node to dest
    nxt = np.full(n, -1, np.int64)  # next node on the path to dest
    via_chan = np.full(n, -1, np.int64)
    via_dir = np.zeros(n, np.int8)
    hops = np.zeros(n, np.int32)

    dist[dst] = 0.0
    amount[dst] = amount_msat
    delay[dst] = final_cltv
    pq = [(0.0, dst)]
    adj_off = g.adj_off

    while pq:
        d_v, v = heapq.heappop(pq)
        if d_v > dist[v]:
            continue
        if v == src:
            break
        if hops[v] >= max_hops:
            continue
        amt_v = int(amount[v])
        # the CSR is keyed by destination: these are exactly the
        # forwarding edges INTO v (u → v), one per updated direction
        for e in range(adj_off[v], adj_off[v + 1]):
            c = int(g.adj_chan[e])
            u = int(g.adj_src[e])
            d = int(g.adj_dir[e])
            if (not g.enabled[d, c]
                    or int(g.scids[c]) in excluded_scids):
                continue
            fee = hop_fee_msat(int(g.fee_base_msat[d, c]),
                               int(g.fee_ppm[d, c]), amt_v)
            amt_u = amt_v + fee
            # the HTLC carried over u→v is amt_v (what v receives) —
            # channel_update limits apply to it, not to amt_u
            # (common/route.c amount semantics)
            if amt_v < int(g.htlc_min_msat[d, c]):
                continue
            hmax = int(g.htlc_max_msat[d, c])
            if hmax and amt_v > hmax:
                continue
            cd = int(g.cltv_delta[d, c])
            cost = dist[v] + fee + _risk_msat(amt_v, cd, riskfactor)
            if cost < dist[u]:
                dist[u] = cost
                amount[u] = amt_u
                delay[u] = delay[v] + cd
                nxt[u] = v
                via_chan[u] = c
                via_dir[u] = d
                hops[u] = hops[v] + 1
                heapq.heappush(pq, (cost, u))

    if dist[src] == INF:
        raise NoRoute(noroute_msg(source, destination, amount_msat))

    route: list[RouteHop] = []
    u = src
    while u != dst:
        v = int(nxt[u])
        route.append(RouteHop(
            node_id=bytes(g.node_ids[v]),
            scid=int(g.scids[via_chan[u]]),
            direction=int(via_dir[u]),
            amount_msat=int(amount[v]),
            delay=int(delay[v]),
        ))
        u = v
    if with_source:
        return route, (int(amount[src]), int(delay[src]))
    return route


def route_fee_msat(route: list[RouteHop], amount_msat: int) -> int:
    """Total fee the source pays on top of the delivered amount (the
    source charges itself nothing for the first hop, so the amount sent
    is what must arrive at the first hop's destination)."""
    if not route:
        return 0
    return route[0].amount_msat - amount_msat
