"""The port's getroute path (lightning_tpu_torch.routing: dijkstra,
planes, device, R1's plain version) against the JAX package's, on the
CPU, compared exactly.

The JAX package's routing/device.py runs ``from jax.experimental import
enable_x64``, which the installed jax (0.9) no longer has; it has
``jax.enable_x64``.  The ``ref`` fixture sets the one to the other for
the import and drops the imported module again afterwards, so nothing
leaks into other test files.  Every graph pads to the reference's small
planes shape (n_pad 64, e_pad 256) and every batch is Q = 8, so its
route program compiles once.
"""
from __future__ import annotations

import asyncio
import importlib
import sys

import numpy as np
import pytest
import torch

from lightning_tpu.gossip import gossmap as RG
from lightning_tpu.gossip import store as RS
from lightning_tpu.gossip import synth as RSY
from lightning_tpu.routing import dijkstra as RDJ
from lightning_tpu.routing.planes import RoutePlanes as RefPlanes
from lightning_tpu_torch import convert
from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import overload
from lightning_tpu_torch.routing import device as TD
from lightning_tpu_torch.routing import dijkstra as TDJ
from lightning_tpu_torch.routing import hopper_route as HR
from lightning_tpu_torch.routing import planes as planes_mod
from lightning_tpu_torch.routing.planes import RoutePlanes

torch.set_num_threads(1)

Q = 8
CPU = "cpu"
PLANE_FIELDS = ("edge_src", "edge_dst", "edge_chan", "edge_dir",
                "edge_base", "edge_ppm", "edge_cltv", "edge_hmin",
                "edge_hmax", "edge_enabled", "edge_cap_sat")


@pytest.fixture(scope="module")
def ref():
    """lightning_tpu.routing.device, imported under the enable_x64 shim."""
    import jax
    import jax.experimental

    name = "lightning_tpu.routing.device"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mod = importlib.import_module(name)
        yield mod
    sys.modules.pop(name, None)
    pkg = sys.modules["lightning_tpu.routing"]
    if getattr(pkg, "device", None) is mod:
        delattr(pkg, "device")


def _net(tmp_path, n_channels, n_nodes, seed):
    p = str(tmp_path / f"net{n_channels}_{seed}.gs")
    RSY.make_network_store(p, n_channels=n_channels, n_nodes=n_nodes,
                           updates_per_channel=2, seed=seed, sign=False)
    g = RG.from_store(RS.load_store(p))
    assert g.n_nodes <= 64 and 2 * g.n_channels <= 256
    return g


def _constrain(g, rng, hmax_free=0):
    """Ragged constraints: disabled channels, htlc_min floors, tight
    htlc_max caps; `hmax_free` channels lose their cap and get the top
    ppm (an amount near 2^48 then trips the overflow guard)."""
    nc = g.n_channels
    g.enabled[:, rng.integers(0, nc, nc // 10)] = False
    g.htlc_min_msat[:, rng.integers(0, nc, nc // 8)] = 50_000
    g.htlc_max_msat[:, rng.integers(0, nc, nc // 8)] = 80_000
    free = rng.choice(nc, hmax_free, replace=False)
    g.htlc_max_msat[:, free] = 0
    g.htlc_min_msat[:, free] = 0
    g.enabled[:, free] = True
    g.fee_ppm[:, free] = 9_999
    return g


def _hops(route):
    return [(h.node_id, h.scid, h.direction, h.amount_msat, h.delay)
            for h in route]


def _canon(results):
    return [(r[0], _hops(r[1]), r[2]) if r[0] == "ok"
            else (r[0], repr(r[1]) if r[0] == "error" else r[1])
            for r in results]


def _queries(rng, g, mod, n=Q, amounts=None):
    out = []
    for i in range(n):
        a, b = rng.choice(g.n_nodes, 2, replace=False)
        amt = int(rng.integers(1_000, 10_000_000)) if amounts is None \
            else amounts[i % len(amounts)]
        out.append(mod.RouteQuery(
            bytes(g.node_ids[a]), bytes(g.node_ids[b]), amt,
            final_cltv=int(rng.integers(9, 40)),
            riskfactor=int(rng.choice([1, 10, 100]))))
    return out


def _port_queries(qs):
    return [TD.RouteQuery(q.source, q.destination, q.amount_msat,
                          q.final_cltv, q.riskfactor, q.max_hops,
                          q.excluded_scids) for q in qs]


@pytest.mark.parametrize("seed", [3, 11])
def test_planes_equal_reference_bit_for_bit(tmp_path, seed):
    g = _constrain(_net(tmp_path, 100, 40, seed),
                   np.random.default_rng(seed))
    want = RefPlanes.build(g)
    got = RoutePlanes.build(convert.gossmap(g), device=CPU)
    for k in PLANE_FIELDS:
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("n_real", "n_pad", "e_real", "e_pad", "topo_version",
              "params_version", "params_log_pos"):
        assert getattr(want, k) == getattr(got, k), k
    scids = [int(s) for s in g.scids[:5]] + [12345]
    assert np.array_equal(want.edge_ok_mask(set(scids)),
                          got.edge_ok_mask(set(scids)))


def _lanes(planes, rng, n_nodes, amounts, excluded=()):
    ok = np.stack([planes.edge_ok_mask(set(excluded) if i % 3 == 0
                                       else None) for i in range(Q)])
    src = rng.integers(0, n_nodes, Q).astype(np.int32)
    dst = rng.integers(0, n_nodes, Q).astype(np.int32)
    amount = np.asarray(amounts, np.int64)
    cltv = rng.integers(9, 40, Q).astype(np.int64)
    rf = rng.choice([0, 1, 10, 1_000_000], Q).astype(np.int64)
    return ok, src, dst, amount, cltv, rf


def test_route_sweep_plain_matches_jit_route(ref, tmp_path):
    """R1's plain version against the reference program: dist at the
    source, via and the overflow flag, equal as arrays, on graphs with
    ragged degree, disabled channels, excluded scids, HTLC windows, an
    isolated (unreachable) node and amounts that trip the overflow
    guard."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    ovf_seen = reach_none = 0
    for seed in (3, 29):
        g = _constrain(_net(tmp_path, 100, 40, seed), rng, hmax_free=12)
        iso = g.n_nodes // 2
        g.enabled[:, (g.node1 == iso) | (g.node2 == iso)] = False
        want_p = RefPlanes.build(g)
        got_p = RoutePlanes.build(convert.gossmap(g), device=CPU)
        excl = [int(s) for s in rng.choice(g.scids, 6, replace=False)]
        for amounts in ([1_000, 60_000, 10**7, 1 << 48, 1 << 47, 0,
                         5 * 10**5, 10**12],
                        [int(a) for a in rng.integers(1, 10**9, Q)]):
            lanes = _lanes(got_p, rng, g.n_nodes, amounts, excl)
            lanes[2][0] = iso
            with jax.enable_x64(True):
                want = ref._jit_route(want_p.n_pad, 20)(
                    *(jnp.asarray(getattr(want_p, k))
                      for k in ref._PLANE_ORDER),
                    *(jnp.asarray(a) for a in lanes))
                want = [np.asarray(w) for w in want]
            got = HR.route_sweep_plain(
                *(torch.as_tensor(getattr(got_p, k))
                  for k in TD._PLANE_ORDER),
                *(torch.as_tensor(a) for a in lanes), got_p.n_pad, 20)
            for w, h in zip(want, got):
                assert w.dtype == h.numpy().dtype
                assert np.array_equal(w, h.numpy())
            ovf_seen += int(want[2].sum())
            reach_none += int((want[0] >= TD.INF_COST).sum())
    assert ovf_seen > 0 and reach_none > 0


def test_solve_batch_matches_reference(ref, tmp_path):
    """solve_batch's tuples equal the reference's (hops, amounts,
    delays, host-answer reasons, noroute messages), edge cases
    included: src == dst, an unknown node, amount and riskfactor caps,
    max_hops = 10, excluded scids and an unreachable destination; and
    every device answer prices like dijkstra."""
    rng = np.random.default_rng(42)
    for seed in (3, 11, 29):
        g = _constrain(_net(tmp_path, 100, 40, seed), rng)
        tg = convert.gossmap(g)
        want_p = RefPlanes.build(g)
        got_p = RoutePlanes.build(tg, device=CPU)
        qs = _queries(rng, g, ref) + _queries(rng, g, ref, amounts=[
            1_000, 123_456, 10**8, 10**9])
        a, b = bytes(g.node_ids[0]), bytes(g.node_ids[1])
        qs[1].excluded_scids = {int(s) for s in g.scids[::3]}
        qs += [ref.RouteQuery(a, a, 1_000),
               ref.RouteQuery(a, b"\x02" * 33, 1_000),
               ref.RouteQuery(a, b, ref.ROUTE_MAX_AMOUNT_MSAT + 1),
               ref.RouteQuery(a, b, 1_000,
                              riskfactor=ref.ROUTE_MAX_RISKFACTOR + 1),
               ref.RouteQuery(a, b, 1_000, max_hops=10)]
        want = ref.solve_batch(want_p, qs, batch=Q)
        got = TD.solve_batch(got_p, _port_queries(qs), batch=Q)
        assert _canon(got) == _canon(want)
        assert [r[1] for r in got[-3:]] == [
            TD.R_AMOUNT_CAP, TD.R_RISKFACTOR_CAP, TD.R_MAX_HOPS]
        for q, r in zip(qs, got):
            if r[0] != "ok":
                continue
            route, src = TDJ.getroute(
                tg, q.source, q.destination, q.amount_msat,
                final_cltv=q.final_cltv, riskfactor=q.riskfactor,
                excluded_scids=q.excluded_scids, with_source=True)
            assert TD.route_cost_msat(tg, r[1], q.riskfactor) == \
                TD.route_cost_msat(tg, route, q.riskfactor)
            if _hops(route) == _hops(r[1]):
                assert src == r[2]


def test_dijkstra_matches_reference(tmp_path):
    rng = np.random.default_rng(9)
    g = _constrain(_net(tmp_path, 100, 40, 7), rng)
    tg = convert.gossmap(g)
    for q in _queries(rng, g, TD, n=24):
        out = []
        for mod, gg in ((RDJ, g), (TDJ, tg)):
            try:
                r = mod.getroute(gg, q.source, q.destination, q.amount_msat,
                                 final_cltv=q.final_cltv,
                                 riskfactor=q.riskfactor, with_source=True)
                out.append((_hops(r[0]), r[1]))
            except mod.NoRoute as e:
                out.append(str(e))
        assert out[0] == out[1]


def _deltas(s0, s1, name):
    """{labels: increase} of a family between two obs snapshots (a
    histogram's observation count), zero entries left out."""
    def vals(snap):
        fam = snap["metrics"].get(name, {"samples": []})
        return {tuple(x["labels"].values()):
                x.get("value", x.get("count", 0)) for x in fam["samples"]}
    a, b = vals(s0), vals(s1)
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


def _service_run(tg, queries, **kw):
    """The queries through one RouteService; returns its results and
    what the run counted: flushes, loop restarts, host answers by
    reason, queries by (path, outcome) and the run's flight records."""
    TB.reset_for_tests()
    last = max([r["dispatch_id"] for r in TFL.recent("route")] or [0])

    async def go():
        svc = TD.RouteService(lambda: tg, device=CPU, batch=Q,
                              flush_ms=20.0, **kw)
        svc.start()
        res = await asyncio.gather(
            *(svc.getroute(q.source, q.destination, q.amount_msat,
                           q.final_cltv, q.riskfactor, q.max_hops,
                           q.excluded_scids, with_source=True)
              for q in queries), return_exceptions=True)
        await svc.close()
        return res
    s0 = TO.snapshot()
    res = asyncio.run(go())
    s1 = TO.snapshot()
    st = {"flushes": sum(_deltas(s0, s1, "clntpu_route_flush_seconds")
                         .values()),
          "restarts": sum(_deltas(s0, s1, "clntpu_loop_restarts_total")
                          .values()),
          "host": {k[0]: v for k, v in
                   _deltas(s0, s1, "clntpu_route_fallback_total").items()},
          "queries": _deltas(s0, s1, "clntpu_route_queries_total"),
          "records": [r for r in TFL.recent("route")
                      if r["dispatch_id"] > last]}
    return st, res


def test_route_service_coalesces_and_counts_host_answers(tmp_path):
    rng = np.random.default_rng(13)
    g = _constrain(_net(tmp_path, 100, 40, 11), rng)
    tg = convert.gossmap(g)
    qs = _queries(rng, g, TD, n=Q - 2)
    a, b = qs[0].source, qs[0].destination
    qs += [TD.RouteQuery(a, b, TD.ROUTE_MAX_AMOUNT_MSAT + 1),
           TD.RouteQuery(a, b, 50_000, max_hops=10)]
    st, res = _service_run(tg, qs)
    assert st["flushes"] == 1 and st["restarts"] == 0
    assert st["host"] == {TD.R_AMOUNT_CAP: 1, TD.R_MAX_HOPS: 1}
    rec, = st["records"]
    assert (rec["outcome"], rec["n_real"], rec["lanes"]) == ("ok", Q - 2, Q)
    assert sum(st["queries"].values()) == Q
    assert sum(n for (path, _), n in st["queries"].items()
               if path == "device") == Q - 2
    for q, r in zip(qs, res):
        try:
            want = TDJ.getroute(tg, q.source, q.destination, q.amount_msat,
                                q.final_cltv, q.riskfactor, q.max_hops,
                                with_source=True)
        except TDJ.NoRoute:
            assert isinstance(r, TDJ.NoRoute)
            continue
        assert TD.route_cost_msat(tg, r[0], q.riskfactor) == \
            TD.route_cost_msat(tg, want[0], q.riskfactor)
    # a flush of a few queries goes to the card all the same
    st, _ = _service_run(tg, qs[:3])
    assert st["host"] == {} and st["records"][0]["n_real"] == 3
    # admission past the high watermark refuses, retryably
    st, res = _service_run(tg, qs[:5], high_wm=2)
    refused = [r for r in res if isinstance(r, overload.Overloaded)]
    assert len(refused) == 3 and refused[0].retry_after_s > 0
    assert st["flushes"] == 1 and sum(st["queries"].values()) == 2


def test_route_service_dispatch_error_fails_the_flush(tmp_path,
                                                      monkeypatch):
    """A dispatch that raises fails its queries with the error: the
    breaker counts a failure, the flush's flight record reads "error",
    the loop runs on (no restart), and nothing is answered by the
    host."""
    g = _net(tmp_path, 60, 16, 7)
    tg = convert.gossmap(g)
    qs = _queries(np.random.default_rng(1), g, TD, n=3)

    def boom(*a, **k):
        raise RuntimeError("card lost")

    monkeypatch.setattr(TD, "solve_batch", boom)
    st, res = _service_run(tg, qs)
    assert all(isinstance(r, RuntimeError) and "card lost" in str(r)
               for r in res)
    assert st["restarts"] == 0 and st["host"] == {}
    assert st["queries"] == {("device", "error"): 3}
    assert [(r["outcome"], r["error"]) for r in st["records"]] == [
        ("error", "RuntimeError")]
    assert TB.get("route").consecutive_failures == 1

    async def stopped():
        svc = TD.RouteService(lambda: tg, device=CPU)
        with pytest.raises(RuntimeError, match="not running"):
            await svc.getroute(qs[0].source, qs[0].destination, 1_000)
    asyncio.run(stopped())


def test_patched_planes_equal_fresh_build(tmp_path):
    """Channel updates patch the touched lanes (host arrays and the
    tensors in ``dev``) to exactly a fresh build's, and a re-solve gives
    the fresh build's answers."""
    rng = np.random.default_rng(21)
    tg = convert.gossmap(_net(tmp_path, 100, 40, 3))
    old = RoutePlanes.build(tg, device=CPU)
    qs = _port_queries(_queries(rng, tg, TD))
    TD.solve_batch(old, qs, batch=Q)               # uploads the planes
    stale = {k: v.clone() for k, v in old.dev.items()}
    for c in rng.choice(tg.n_channels, 12, replace=False):
        d = int(rng.integers(0, 2))
        assert tg.apply_channel_update(
            int(tg.scids[c]), d, timestamp=int(tg.timestamps[d, c]) + 1,
            disabled=bool(rng.integers(0, 2)), cltv_delta=40,
            htlc_min_msat=int(rng.integers(0, 1000)),
            htlc_max_msat=int(rng.integers(0, 1 << 30)),
            fee_base_msat=int(rng.integers(0, 5000)),
            fee_ppm=int(rng.integers(0, 10000)))
    new = RoutePlanes.current(tg, old, device=CPU)
    assert new.patch_idx is not None and len(new.patch_idx) == 12
    fresh = RoutePlanes.build(tg, device=CPU)
    for k in PLANE_FIELDS:
        assert np.array_equal(getattr(new, k), getattr(fresh, k)), k
    got = TD.solve_batch(new, qs, batch=Q)
    want = TD.solve_batch(fresh, qs, batch=Q)
    assert _canon(got) == _canon(want)
    for k in TD._PLANE_ORDER:
        assert torch.equal(new.dev[k], fresh.dev[k]), k
        assert torch.equal(old.dev[k], stale[k]), k   # untouched
    # a burst past the patch threshold re-derives every parameter plane
    for c in range(tg.n_channels):
        assert tg.apply_channel_update(
            int(tg.scids[c]), 1, timestamp=int(tg.timestamps[1, c]) + 1,
            disabled=False, cltv_delta=12, htlc_min_msat=0,
            htlc_max_msat=0, fee_base_msat=c, fee_ppm=3 * c)
    burst = RoutePlanes.current(tg, new, device=CPU)
    assert burst.patch_idx is None and set(burst.dev) == {"edge_src",
                                                           "edge_dst"}
    fresh = RoutePlanes.build(tg, device=CPU)
    assert _canon(TD.solve_batch(burst, qs, batch=Q)) == _canon(
        TD.solve_batch(fresh, qs, batch=Q))
    for k in TD._PLANE_ORDER:
        assert torch.equal(burst.dev[k], fresh.dev[k]), k


# ---------------------------------------------------------------------------
# R1's frontier algorithm, emulated step by step on the CPU

L_OVF = 1 << 61
MAX_HOPS = 20


def _unsafe(a, ppm, cdr):
    """The kernel's division-free guard: a > 2^61 // max(p, 1) for either
    product, as a * max(p, 1) > 2^61."""
    return a > 0 and (a * max(ppm, 1) > L_OVF or a * max(cdr, 1) > L_OVF)


def _frontier_sweep(p, in_off, ok, src, dst, amount, cltv, rf, n, rng):
    """One query through route_sweep.cu's sweeps, in a random order of
    the frontier's edges (the kernel's atomics fold in any order): pass
    A over the frontier's in-edges only (a tail is listed by the first
    edge that lowers it, an edge goes on the work list with its
    candidate when at or below the minimum it met), pass B reading the
    work list, pass C staging the amount and delay read from the labels
    before the sweep, the owner moving the stage into the labels at the
    next pass A; the stop at the first sweep that lists no node.
    Returns (dist at src, via, ovf, sweeps run, edges priced)."""
    es, ed, base, ppm, cd, hmin, hmax = (p[k].tolist() for k in (
        "edge_src", "edge_dst", "edge_base", "edge_ppm", "edge_cltv",
        "edge_hmin", "edge_hmax"))
    dist = [TD.INF_COST] * n
    amt, dly, via = [0] * n, [0] * n, [-1] * n
    dist[dst] = 0
    frontier = [(dst, amount, cltv)]          # (node, staged amt, delay)
    ovf, sweeps, priced = False, 0, 0
    for _ in range(MAX_HOPS):
        if not frontier:
            break
        sweeps += 1
        for v, a, d in frontier:
            amt[v], dly[v] = a, d
        pairs = [(v, a, e) for v, a, _ in frontier
                 for e in range(in_off[v], in_off[v + 1])]
        priced += len(pairs)
        best, listed, work = {}, [], []
        for i in rng.permutation(len(pairs)):
            v, a_v, e = pairs[i]
            d_v = dist[v]
            if not (ok[e] and d_v < TD.INF_COST and a_v >= hmin[e]
                    and (hmax[e] == 0 or a_v <= hmax[e])):
                continue
            cdr = cd[e] * rf
            if _unsafe(a_v, ppm[e], cdr):
                ovf = True
                continue
            cand = d_v + base[e] + a_v * ppm[e] // 10**6 + 1 \
                + a_v * cdr // HR.RISK_DENOM
            u = es[e]
            if cand < dist[u]:
                old = best.get(u, HR.I64_MAX)
                best[u] = min(old, cand)
                if old == HR.I64_MAX:
                    listed.append(u)
                if cand <= old:
                    work.append((e, cand))
        best_e = {}
        for i in rng.permutation(len(work)):
            e, cand = work[i]
            if cand == best[es[e]]:
                best_e[es[e]] = min(best_e.get(es[e], HR.I32_MAX), e)
        frontier = []
        for u in listed:
            e = best_e[u]
            a_w = amt[ed[e]]
            dist[u] = best[u]
            frontier.append((u, a_w + base[e] + a_w * ppm[e] // 10**6,
                             dly[ed[e]] + cd[e]))
            via[u] = e
    return dist[src], via, ovf, sweeps, priced


def _random_graph(rng, n_pad=64, e_pad=256):
    """Planes of a random graph, edges sorted by destination: parallel
    edges, a few self-loops, fee and window values drawn from small sets
    (equal-cost ties), disabled edges, and node 1 with no in-edge."""
    n = int(rng.integers(3, n_pad + 1))
    m = int(rng.integers(1, e_pad + 1))
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    v[v == 1] = 0
    dup = rng.random(m) < 0.15
    u[1:][dup[1:]], v[1:][dup[1:]] = u[:-1][dup[1:]], v[:-1][dup[1:]]
    order = np.argsort(v, kind="stable")
    pick = rng.choice

    def lane(vals, dtype=np.int64):
        out = np.zeros(e_pad, dtype)
        out[:m] = pick(vals, m)
        return out

    p = {"edge_src": np.zeros(e_pad, np.int32),
         "edge_dst": np.zeros(e_pad, np.int32),
         "edge_base": lane([0, 0, 1, 1000]),
         "edge_ppm": lane([0, 1, 10, 1000, 9_999, 10**6]),
         "edge_cltv": lane([0, 6, 40, 144]),
         "edge_hmin": lane([0, 0, 0, 50_000, 1 << 40]),
         "edge_hmax": lane([0, 0, 0, 80_000, 10**9, 1 << 45])}
    p["edge_src"][:m], p["edge_dst"][:m] = u[order], v[order]
    enabled = np.zeros(e_pad, bool)
    enabled[:m] = rng.random(m) < 0.9
    return p, n, m, enabled


def _chain_graph(hops, n_pad=64, e_pad=256):
    """Nodes 0 .. hops, edge i + 1 -> i for each i: a path of `hops`
    edges from node `hops` to node 0."""
    p = {k: np.zeros(e_pad, np.int64) for k in (
        "edge_base", "edge_ppm", "edge_cltv", "edge_hmin", "edge_hmax")}
    p["edge_src"] = np.zeros(e_pad, np.int32)
    p["edge_dst"] = np.zeros(e_pad, np.int32)
    p["edge_src"][:hops] = np.arange(1, hops + 1)
    p["edge_dst"][:hops] = np.arange(hops)
    p["edge_base"][:hops] = 1
    p["edge_cltv"][:hops] = 6
    enabled = np.zeros(e_pad, bool)
    enabled[:hops] = True
    return p, hops + 1, hops, enabled


def test_route_frontier_emulation_matches_jit_route(ref):
    """The kernel's frontier sweep, emulated query by query on about 200
    seeded random graphs, against the reference program and R1's plain
    version: dist at the source, via and the overflow flag equal
    exactly.  Ties on equal cost, parallel edges, self-loops, disabled
    and excluded edges, HTLC windows, amounts that force the overflow
    flag, an isolated destination, and a chain of exactly 20 hops
    (found) and one of 21 (not found, though 21 > 20 sweeps would)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2024)
    run = ref._jit_route(64, MAX_HOPS)
    seen = {"ovf": 0, "unreached": 0, "reached": 0, "short": 0}
    cases = [_random_graph(rng) for _ in range(198)]
    cases += [_chain_graph(MAX_HOPS + 1)] * 2
    for i, (p, n, m, enabled) in enumerate(cases):
        in_off = planes_mod.in_csr(p["edge_dst"][:m], 64)
        ok = np.stack([enabled & (rng.random(256) < 0.9) for _ in range(Q)])
        src = rng.integers(0, n, Q).astype(np.int32)
        dst = rng.integers(0, n, Q).astype(np.int32)
        dst[0] = 1                                  # no in-edges
        amount = rng.choice([0, 1_000, 60_000, 10**7, 10**9, 1 << 40,
                             1 << 47, 1 << 48], Q).astype(np.int64)
        cltv = rng.integers(9, 40, Q).astype(np.int64)
        rf = rng.choice([0, 1, 10, 1_000_000], Q).astype(np.int64)
        if i >= len(cases) - 2:                     # the chains
            ok[:] = enabled
            src[:] = [MAX_HOPS, MAX_HOPS + 1] * (Q // 2)
            dst[:] = 0
            amount[:] = 10_000
        lanes = (ok, src, dst, amount, cltv, rf)
        with jax.enable_x64(True):
            want = [np.asarray(w) for w in run(
                *(jnp.asarray(p[k]) for k in ref._PLANE_ORDER),
                *(jnp.asarray(a) for a in lanes))]
        plain = [t.numpy() for t in HR.route_sweep_plain(
            *(torch.as_tensor(p[k]) for k in TD._PLANE_ORDER),
            *(torch.as_tensor(a) for a in lanes), 64, MAX_HOPS,
            in_off=torch.as_tensor(in_off))]
        for j in range(Q):
            d, via, ovf, sweeps, priced = _frontier_sweep(
                p, in_off.tolist(), ok[j].tolist(), int(src[j]),
                int(dst[j]), int(amount[j]), int(cltv[j]), int(rf[j]), 64,
                rng)
            for got in ((d, via, ovf), (plain[0][j], plain[1][j],
                                        plain[2][j])):
                assert got[0] == want[0][j], (i, j)
                assert np.array_equal(got[1], want[1][j]), (i, j)
                assert bool(got[2]) == bool(want[2][j]), (i, j)
            assert 1 <= sweeps <= MAX_HOPS and priced <= MAX_HOPS * m
            seen["ovf"] += ovf
            seen["unreached"] += d >= TD.INF_COST
            seen["reached"] += d < TD.INF_COST and src[j] != dst[j]
            seen["short"] += sweeps < MAX_HOPS
            if j == 0 and i < len(cases) - 2:
                assert sweeps == 1 and priced == 0   # isolated dst
        if i >= len(cases) - 2:
            assert (want[0][0::2] < TD.INF_COST).all()
            assert (want[0][1::2] >= TD.INF_COST).all()
    assert all(v > 50 for v in seen.values()), seen
