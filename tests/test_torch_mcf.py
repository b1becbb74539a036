"""The port's getroutes path (lightning_tpu_torch.routing: mcf,
mcf_device, R2's plain version) against the JAX package's, on the CPU,
compared exactly: result dicts byte for byte, lanes bit for bit.

The JAX package's routing/mcf_device.py is imported under the
``jax.experimental.enable_x64 = jax.enable_x64`` shim (see
tests/test_torch_route.py) and dropped again afterwards.  Every graph
keeps 8 * n_channels <= 256 forward arcs and n_nodes <= 64, so the
reference program compiles at one shape (n_pad 64, a_fwd_pad 256).
"""
from __future__ import annotations

import asyncio
import copy
import importlib
import sys

import numpy as np
import pytest
import torch

from lightning_tpu.gossip import gossmap as RG
from lightning_tpu.gossip import store as RS
from lightning_tpu.gossip import synth as RSY
from lightning_tpu.routing import mcf as RMCF
from lightning_tpu_torch import convert
from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.routing import hopper_route as HR
from lightning_tpu_torch.routing import mcf as TMCF
from lightning_tpu_torch.routing import mcf_device as TM

torch.set_num_threads(1)

Q = 8
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """lightning_tpu.routing.mcf_device, imported under the enable_x64
    shim."""
    import jax
    import jax.experimental

    name = "lightning_tpu.routing.mcf_device"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        mod = importlib.import_module(name)
        yield mod
    sys.modules.pop(name, None)
    pkg = sys.modules["lightning_tpu.routing"]
    if getattr(pkg, "mcf_device", None) is mod:
        delattr(pkg, "mcf_device")


def _net(tmp_path, n_channels, n_nodes, seed):
    p = str(tmp_path / f"m{n_channels}_{seed}.gs")
    RSY.make_network_store(p, n_channels=n_channels, n_nodes=n_nodes,
                           updates_per_channel=2, seed=seed, sign=False)
    g = RG.from_store(RS.load_store(p))
    assert g.n_nodes <= 64 and 8 * g.n_channels <= 256
    return g


def _rand_layers(rng, g, t: int):
    """The reference parity corpus's layer mix: disabled scids, channel
    biases, reservations, liquidity knowledge, node biases, a disabled
    node."""
    ly = RMCF.Layers()
    if t % 3 == 0:
        for s in rng.choice(g.scids, 3, replace=False):
            ly.disabled.add(int(s))
    if t % 4 == 1:
        for s in rng.choice(g.scids, 4, replace=False):
            ly.biases[int(s)] = float(rng.integers(-500, 2000))
    if t % 5 == 2:
        for s in rng.choice(g.scids, 3, replace=False):
            ly.reserve(int(s), int(rng.integers(0, 2)),
                       int(rng.integers(1, 200_000)))
    if t % 7 == 3:
        for s in rng.choice(g.scids, 2, replace=False):
            ly.inform(int(s), int(rng.integers(0, 2)),
                      max_msat=int(rng.integers(0, 100_000)), ts=1.0)
    if t % 11 == 4:
        nid = bytes(g.node_ids[int(rng.integers(0, g.n_nodes))])
        ly.node_biases[nid] = float(rng.integers(-200, 800))
    if t % 13 == 5:
        ly.disabled_nodes.add(bytes(g.node_ids[int(rng.integers(
            0, g.n_nodes))]))
    return ly


def _queries(rng, g, mod, n=Q, layered=True):
    out = []
    for t in range(n):
        a, b = rng.choice(g.n_nodes, 2, replace=False)
        amt = int(rng.integers(10_000, 5_000_000))
        out.append(mod.McfQuery(
            bytes(g.node_ids[a]), bytes(g.node_ids[b]), amt,
            layers=_rand_layers(rng, g, t) if layered else None,
            maxfee_msat=None if t % 2 else int(amt * 0.01),
            max_parts=int(rng.integers(1, 9))))
    return out


def _port_queries(qs):
    return [TM.McfQuery(q.source, q.destination, q.amount_msat,
                        None if q.layers is None
                        else convert.mcf_layers(q.layers),
                        q.maxfee_msat, q.final_cltv, q.max_parts,
                        q.prob_weight, q.delay_weight) for q in qs]


def _host(mod, g, q):
    try:
        return ("ok", mod.getroutes(
            g, q.source, q.destination, q.amount_msat, layers=q.layers,
            maxfee_msat=q.maxfee_msat, final_cltv=q.final_cltv,
            max_parts=q.max_parts))
    except mod.McfError as e:
        return ("mcferr", str(e))


def _canon(res):
    return [(r[0], repr(r[1])) if r[0] == "error" else r for r in res]


def test_getroutes_matches_reference_over_layers(tmp_path):
    """The host oracle: result dicts and McfError messages equal, over
    the layer corpus plus a layer-created channel with its update, a
    layer update of a gossip channel and the two-attempt maxfee rule."""
    rng = np.random.default_rng(23)
    for seed in (5, 17):
        g = _net(tmp_path, 30, 20, seed)
        tg = convert.gossmap(g)
        qs = _queries(rng, g, TM, n=10)
        ly = RMCF.Layers()
        ly.created[999_999] = {"source": bytes(g.node_ids[0]),
                               "destination": b"\x03" * 33,
                               "capacity_sat": 50_000}
        ly.updates[(999_999, 0)] = {"enabled": True, "fee_base_msat": 1,
                                    "fee_proportional_millionths": 10}
        ly.updates[(int(g.scids[1]), 1)] = {
            "enabled": False, "fee_base_msat": None}
        qs.append(TM.McfQuery(bytes(g.node_ids[1]), b"\x03" * 33, 30_000,
                              layers=ly))
        qs.append(TM.McfQuery(bytes(g.node_ids[2]), bytes(g.node_ids[3]),
                              4_000_000, maxfee_msat=1))
        for q in qs:
            want = _host(RMCF, g, q)
            pq = _port_queries([q])[0]
            assert _host(TMCF, tg, pq) == want


def test_planes_and_lanes_bitwise(ref, tmp_path):
    rng = np.random.default_rng(3)
    g = _net(tmp_path, 30, 20, 5)
    want = ref.McfPlanes.build(g)
    got = TM.McfPlanes.build(convert.gossmap(g), device=CPU)
    for k in ("i_src", "i_dst"):
        assert np.array_equal(getattr(want, k), getattr(got, k))
    for k in ("n_channels", "n_real", "n_pad", "a_fwd_real", "a_fwd_pad"):
        assert getattr(want, k) == getattr(got, k)
    for d in (0, 1):
        for k in ("u", "v", "enabled", "hmin", "cap0", "fee_ppm", "base",
                  "cltv"):
            a, b = getattr(want.dirs[d], k), getattr(got.dirs[d], k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    for t in range(12):
        ly = _rand_layers(rng, g, t)
        amt = int(rng.integers(1, 10**8))
        for prob in (1.0, 0.01):
            c1, r1 = ref.query_lanes(want, amt, ly, prob, part_hint=t + 1)
            c2, r2 = TM.query_lanes(got, amt, convert.mcf_layers(ly), prob,
                                    part_hint=t + 1)
            assert np.array_equal(c1.view(np.int64), c2.view(np.int64))
            assert np.array_equal(r1, r2)


def _jit(ref, n_pad, a_fwd_pad, i_src, i_dst, ops):
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        out = ref._jit_mcf(n_pad, a_fwd_pad)(
            jnp.asarray(i_src), jnp.asarray(i_dst),
            *(jnp.asarray(a) for a in ops))
        return [np.asarray(o) for o in out]


def _plain(i_src, i_dst, ops, n_pad):
    out = HR.mcf_solve_plain(torch.as_tensor(i_src), torch.as_tensor(i_dst),
                             *(torch.as_tensor(a) for a in ops), n_pad)
    return [o.numpy() for o in out]


def test_mcf_solve_plain_matches_jit_mcf(ref, tmp_path):
    """R2's plain version (with its stops once nothing changes) against
    the reference program's full budget: flows, remaining, nopath and
    walkfail equal as arrays.  On a real graph's lanes (reservations,
    knowledge, slashed reliability weight), and on random residual
    graphs with many equal costs, -0.0 costs, negative cycles (walk
    failures), dead ends (no path) and augmentation caps."""
    rng = np.random.default_rng(7)
    g = _net(tmp_path, 30, 20, 5)
    planes = TM.McfPlanes.build(convert.gossmap(g), device=CPU)
    for scale in (1.0, 0.01):
        sub = [None] * Q
        ops = TM._prep_chunk(planes, _port_queries(_queries(rng, g, TM)),
                             Q, scale, sub)
        want = _jit(ref, planes.n_pad, planes.a_fwd_pad, planes.i_src,
                    planes.i_dst, ops)
        got = _plain(planes.i_src, planes.i_dst, ops, planes.n_pad)
        for w, h in zip(want, got):
            assert w.dtype == h.dtype and np.array_equal(w, h)
    flags = np.zeros(3, int)
    n, af = 64, 64
    for case in range(8):
        fs = rng.integers(0, 12, af).astype(np.int32)
        fd = rng.integers(0, 12, af).astype(np.int32)
        i_src = np.stack([fs, fd], 1).reshape(-1)
        i_dst = np.stack([fd, fs], 1).reshape(-1)
        vals = (np.array([0.0, -0.0, 1.0, 2.0, 3.0, -1.0, 0.5, 1e-10])
                if case % 2 else rng.normal(0, 5, 20))
        ops = (rng.choice(vals, (Q, af)).astype(np.float64),
               (rng.integers(0, 50, (Q, af))
                * (rng.random((Q, af)) < 0.7)).astype(np.int64),
               rng.integers(0, 12, Q).astype(np.int32),
               rng.integers(0, 12, Q).astype(np.int32),
               rng.integers(1, 200, Q).astype(np.int64),
               rng.integers(0, 65, Q).astype(np.int32))
        want = _jit(ref, n, af, i_src, i_dst, ops)
        got = _plain(i_src, i_dst, ops, n)
        for w, h in zip(want, got):
            assert w.dtype == h.dtype and np.array_equal(w, h)
        flags += [int((want[1] > 0).sum()), int(want[2].sum()),
                  int(want[3].sum())]
    assert (flags > 0).all()          # unplaced, nopath and walkfail seen


def test_solve_mcf_batch_matches_reference_and_oracle(ref, tmp_path):
    rng = np.random.default_rng(31)
    for seed in (5, 17):
        g = _net(tmp_path, 30, 20, seed)
        tg = convert.gossmap(g)
        want_p = ref.McfPlanes.build(g)
        got_p = TM.McfPlanes.build(tg, device=CPU)
        qs = _queries(rng, g, ref, n=2 * Q)
        a, b = bytes(g.node_ids[0]), bytes(g.node_ids[1])
        qs += [ref.McfQuery(a, a, 1_000),
               ref.McfQuery(a, b"\x02" * 33, 1_000),
               ref.McfQuery(a, b, ref.MCF_MAX_AMOUNT_MSAT + 1),
               ref.McfQuery(a, b, 1_000, max_parts=17),
               ref.McfQuery(a, b, 4_000_000, maxfee_msat=1)]
        want = ref.solve_mcf_batch(want_p, qs, batch=Q)
        pq = _port_queries(qs)
        got = TM.solve_mcf_batch(got_p, pq, batch=Q)
        assert _canon(got) == _canon(want)
        assert sum(r[0] == "ok" for r in got) >= Q
        for q, r in zip(pq, got):
            if r[0] in ("ok", "mcferr") and r != ("mcferr",
                                                  "source is destination"):
                assert _host(TMCF, tg, q) == r


def _deltas(s0, s1, name):
    """{labels: increase} of a family between two obs snapshots (a
    histogram's observation count), zero entries left out."""
    def vals(snap):
        fam = snap["metrics"].get(name, {"samples": []})
        return {tuple(x["labels"].values()):
                x.get("value", x.get("count", 0)) for x in fam["samples"]}
    a, b = vals(s0), vals(s1)
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


def _counts(s0, s1, last_id):
    """What a McfService run counted between two snapshots: flushes,
    loop restarts, host answers by reason, queries by (path, outcome)
    and the run's flight records."""
    return {
        "flushes": sum(_deltas(s0, s1, "clntpu_mcf_flush_seconds").values()),
        "restarts": sum(_deltas(s0, s1, "clntpu_loop_restarts_total")
                        .values()),
        "host": {k[0]: v for k, v in
                 _deltas(s0, s1, "clntpu_mcf_fallback_total").items()},
        "queries": _deltas(s0, s1, "clntpu_mcf_queries_total"),
        "records": [r for r in TFL.recent("mcf")
                    if r["dispatch_id"] > last_id]}


def _last_id():
    return max([r["dispatch_id"] for r in TFL.recent("mcf")] or [0])


def _service_run(tg, queries, **kw):
    TB.reset_for_tests()
    last = _last_id()

    async def go():
        svc = TM.McfService(lambda: tg, device=CPU, batch=Q, flush_ms=20.0,
                            **kw)
        svc.start()
        res = await asyncio.gather(
            *(svc.getroutes(q.source, q.destination, q.amount_msat,
                            layers=q.layers, maxfee_msat=q.maxfee_msat,
                            max_parts=q.max_parts) for q in queries),
            return_exceptions=True)
        await svc.close()
        return res
    s0 = TO.snapshot()
    res = asyncio.run(go())
    return _counts(s0, TO.snapshot(), last), res


def test_mcf_service_answers_like_the_oracle(tmp_path):
    """Coalesced queries, the two-attempt maxfee path on the device (one
    query passes on the slashed second attempt, one fails both), and a
    layer-created channel answered by the host as layered_topology."""
    rng = np.random.default_rng(41)
    g = _net(tmp_path, 30, 20, 17)
    tg = convert.gossmap(g)
    qs = _port_queries(_queries(rng, g, TM, n=Q - 1, layered=False))
    a, b, amt = bytes(tg.node_ids[16]), bytes(tg.node_ids[13]), 2 * 10**8
    first = TMCF.getroutes(tg, a, b, amt)["fee_msat"]
    second = TMCF.getroutes(tg, a, b, amt, prob_weight=0.01)["fee_msat"]
    assert second < first
    qs += [TM.McfQuery(a, b, amt, maxfee_msat=second),
           TM.McfQuery(a, b, amt, maxfee_msat=second - 1)]
    ly = TMCF.Layers(created={999_999: {
        "source": a, "destination": b"\x03" * 33, "capacity_sat": 50_000}},
        updates={(999_999, 0): {"enabled": True}})
    qs.append(TM.McfQuery(a, b"\x03" * 33, 30_000, layers=ly))
    st, res = _service_run(tg, qs)
    for q, r in zip(qs, res):
        want = _host(TMCF, tg, q)
        if want[0] == "ok":
            assert r == want[1]
        else:
            assert isinstance(r, TMCF.McfError) and str(r) == want[1]
    assert res[-3]["fee_msat"] == second
    assert isinstance(res[-2], TMCF.McfError) and "exceeds maxfee" in \
        str(res[-2])
    assert st["host"] == {TM.R_LAYERED: 1} and st["restarts"] == 0
    assert sum(r["n_real"] for r in st["records"]) == Q + 1
    assert sum(st["queries"].values()) == len(qs)
    assert st["queries"][("host", "ok")] == 1


def test_mcf_service_dispatch_error_fails_the_flush(tmp_path, monkeypatch):
    g = _net(tmp_path, 30, 20, 5)
    tg = convert.gossmap(g)
    qs = _port_queries(_queries(np.random.default_rng(2), g, TM, n=3,
                                layered=False))

    def boom(*a, **k):
        raise RuntimeError("card lost")

    monkeypatch.setattr(TM, "_solve_indices", boom)
    st, res = _service_run(tg, qs)
    assert all(isinstance(r, RuntimeError) and "card lost" in str(r)
               for r in res)
    assert st["restarts"] == 0 and st["host"] == {}
    assert [r["outcome"] for r in st["records"]] == ["error"]


def test_mcf_service_answers_for_the_revision_it_solved(tmp_path,
                                                        monkeypatch):
    """channel_updates to every channel during every dispatch (the maxfee
    second attempt's too) change neither the answers nor where they come
    from: each flush answers, from the card, as mcf.getroutes does on
    the map as the flush found it, and no query waits for another
    flush."""
    g = _net(tmp_path, 30, 20, 17)
    tg = convert.gossmap(g)
    qs = _port_queries(_queries(np.random.default_rng(4), g, TM, n=Q - 1,
                                layered=False))
    a, b, amt = bytes(tg.node_ids[16]), bytes(tg.node_ids[13]), 2 * 10**8
    second = TMCF.getroutes(tg, a, b, amt, prob_weight=0.01)["fee_msat"]
    qs.append(TM.McfQuery(a, b, amt, maxfee_msat=second))
    solve = TM._solve_indices
    dispatches = []

    def move_the_map(*args, **kw):
        out = solve(*args, **kw)
        dispatches.append(len(args[2]))
        for d, c in zip(*np.nonzero(tg.timestamps)):
            assert tg.apply_channel_update(
                int(tg.scids[c]), int(d),
                timestamp=int(tg.timestamps[d, c]) + 1,
                disabled=not tg.enabled[d, c],
                cltv_delta=int(tg.cltv_delta[d, c]) + 1,
                htlc_min_msat=int(tg.htlc_min_msat[d, c]),
                htlc_max_msat=int(tg.htlc_max_msat[d, c]),
                fee_base_msat=int(tg.fee_base_msat[d, c]) + 1000,
                fee_ppm=2 * int(tg.fee_ppm[d, c]) + 1)
        return out

    monkeypatch.setattr(TM, "_solve_indices", move_the_map)

    TB.reset_for_tests()
    last = _last_id()
    s0 = TO.snapshot()

    async def go():
        svc = TM.McfService(lambda: tg, device=CPU, batch=Q, flush_ms=20.0)
        svc.start()
        waves = []
        for _ in range(2):
            before = copy.deepcopy(tg)
            res = await asyncio.gather(
                *(svc.getroutes(q.source, q.destination, q.amount_msat,
                                maxfee_msat=q.maxfee_msat,
                                max_parts=q.max_parts) for q in qs),
                return_exceptions=True)
            waves.append((before, res))
        await svc.close()
        return waves

    waves = asyncio.run(go())
    st = _counts(s0, TO.snapshot(), last)
    assert len(dispatches) == 4 and dispatches[::2] == [Q, Q]
    assert st["flushes"] == 2 and st["host"] == {} and st["restarts"] == 0
    assert sum(st["queries"].values()) == 2 * Q
    assert all(path == "device" for path, _ in st["queries"])
    moved = 0
    for before, res in waves:
        for q, r in zip(qs, res):
            want = _host(TMCF, before, q)
            assert (r == want[1]) if want[0] == "ok" else \
                str(r) == want[1]
            moved += _host(TMCF, tg, q) != want
    assert waves[0][1][-1]["fee_msat"] == second
    assert moved >= Q


def test_tail_order_round_trip(tmp_path):
    """R2's tail order, as ``McfPlanes`` uploads it and the kernel reads
    it: the arcs by tail are the real arcs grouped by tail, their heads
    are ``i_dst`` in that order and ``tail_pos`` inverts the order (-1 for
    the padding).  A query's lanes copied into tail order (signed costs,
    -0.0 included, and residuals; reverse arcs start empty) and back by
    ``tail_pos`` give the lanes again, and zeros on the padding."""
    rng = np.random.default_rng(31)
    planes = TM.McfPlanes.build(convert.gossmap(_net(tmp_path, 30, 20, 5)),
                                device=CPU)
    i_src, i_dst, off, arc, t_dst, t_pos = planes.device_arcs()
    A, Af = 2 * planes.a_fwd_real, planes.a_fwd_pad
    a = arc.long()
    assert torch.equal(torch.sort(a).values, torch.arange(A))
    assert torch.equal(t_pos[a], torch.arange(A, dtype=torch.int32))
    assert (t_pos[A:] == -1).all() and len(t_pos) == 2 * Af
    assert torch.equal(t_dst, i_dst[a])
    for u in range(planes.n_pad):
        seg = a[int(off[u]):int(off[u + 1])]
        assert (i_src[seg] == u).all() and torch.equal(seg, seg.sort()[0])
    cost = torch.as_tensor(rng.choice([0.0, -0.0, 1.5, 2.0, 1e-10], (4, Af)))
    res = torch.as_tensor(rng.integers(0, 1 << 40, (4, Af)))
    rev = (a & 1).bool()
    t_cost = torch.where(rev, -cost[:, a >> 1], cost[:, a >> 1])
    t_res = torch.where(rev, 0, res[:, a >> 1])
    pos = t_pos.long()

    def back(t):
        out = torch.where(pos >= 0, t[:, pos.clamp(min=0)],
                          torch.zeros((), dtype=t.dtype))
        return out[:, 0::2], out[:, 1::2]

    real = A // 2
    fc, rc = back(t_cost)
    assert torch.equal(fc[:, :real].view(torch.int64),
                       cost[:, :real].view(torch.int64))
    assert torch.equal(rc[:, :real].view(torch.int64),
                       (-cost[:, :real]).view(torch.int64))
    fr, rr = back(t_res)
    assert torch.equal(fr[:, :real], res[:, :real])
    assert (rr == 0).all() and (fr[:, real:] == 0).all()
