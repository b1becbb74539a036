"""The port's supervised route and MCF flushes against the JAX package's.

The same query waves go through both packages' RouteService (or
McfService) under the same fault specs, one flush a wave.  The JAX
package re-solves on the host after a device error, an open breaker or a
blown deadline; the port fails those queries instead, and the test
forbids its host solvers outright.  Held, wave by wave:

* the breaker transitions, in sequence;
* the flight-record outcomes, through the mapping stated in
  ``lightning_tpu_torch/routing/device.py``'s docstring;
* the counts of the families both packages keep alike (breaker,
  fault, deadline, dispatch, batch and occupancy families; the queries
  the port failed against those the JAX package sent to the host);
* the answers, wherever both packages answered on the card.

Left out of the comparison: ``clntpu_transfer_bytes_total`` (the
port's planes carry R1's in-edge offsets, and its MCF operands are
laid out for R2), flush seconds' sums, and dispatch and corr ids.

The JAX package's seam fires on the loop just before its deadline's
guard, so a hang spec alone never reaches its guard; its own deadline
tests hang inside the dispatch, and the hang case here does that for it
(the spec is armed in both).  The port fires the seam inside the guard.
"""
from __future__ import annotations

import asyncio
import importlib
import re
import sys
import time

import numpy as np
import pytest
import torch

from lightning_tpu import obs as JO
from lightning_tpu.gossip import gossmap as RG
from lightning_tpu.gossip import store as RS
from lightning_tpu.gossip import synth as RSY
from lightning_tpu.obs import flight as JFL
from lightning_tpu.resilience import breaker as JB
from lightning_tpu.resilience import faultinject as JFI
from lightning_tpu.utils import events as JEV
from lightning_tpu_torch import convert
from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import deadline as TDL
from lightning_tpu_torch.resilience import faultinject as TFI
from lightning_tpu_torch.routing import device as TD
from lightning_tpu_torch.routing import dijkstra as TDJ
from lightning_tpu_torch.routing import mcf as TMCF
from lightning_tpu_torch.routing import mcf_device as TM
from lightning_tpu_torch.utils import events as TEV

torch.set_num_threads(1)

Q = 8
CPU = "cpu"


def _import_shimmed(name):
    """A JAX-package routing module, imported under the enable_x64 shim
    (tests/test_torch_route.py) and dropped again afterwards."""
    import jax
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                   raising=False)
        return importlib.import_module(name)


@pytest.fixture(scope="module")
def ref():
    names = ("lightning_tpu.routing.device",
             "lightning_tpu.routing.mcf_device")
    mods = [_import_shimmed(n) for n in names]
    yield mods
    pkg = sys.modules["lightning_tpu.routing"]
    for n, mod in zip(names, mods):
        sys.modules.pop(n, None)
        attr = n.rsplit(".", 1)[1]
        if getattr(pkg, attr, None) is mod:
            delattr(pkg, attr)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Breakers, armed faults and flight rings are process-global; the
    port's host solvers are forbidden (every query here is one the
    planes express, so the port answers nothing on the host)."""
    for k in ("LIGHTNING_TPU_FAULT", "LIGHTNING_TPU_DEADLINE_ROUTE_S",
              "LIGHTNING_TPU_DEADLINE_MCF_S", "LIGHTNING_TPU_DEADLINE_S"):
        monkeypatch.delenv(k, raising=False)

    def forbidden(*a, **kw):
        raise AssertionError("the port reached a host solver")
    monkeypatch.setattr(TDJ, "getroute", forbidden)
    monkeypatch.setattr(TMCF, "getroutes", forbidden)
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()
    yield
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()


def _outcome_map():
    """The docstring's table: JAX package outcome -> the port's."""
    rows = re.findall(r"^    (\w+(?: \([^)]*\))?)\s{2,}(\w+)$",
                      TD.__doc__, re.M)
    return dict(rows)


def _expected(rec: dict) -> str:
    """The port's outcome for the flush the JAX package recorded as
    ``rec``, read through the docstring's table."""
    table = _outcome_map()
    oc = rec["outcome"]
    if oc == "host":
        oc = ("host (after a device error)" if rec.get("error")
              else "host (a flush with no device share)")
    return table[oc]


def test_the_outcome_mapping_is_the_stated_one():
    assert _outcome_map() == {
        "ok": "ok", "host (after a device error)": "error",
        "host_breaker": "breaker", "deadline": "deadline",
        "host (a flush with no device share)": "host"}


def _net(tmp_path, n_channels, n_nodes, seed):
    p = str(tmp_path / f"s{n_channels}_{seed}.gs")
    RSY.make_network_store(p, n_channels=n_channels, n_nodes=n_nodes,
                           updates_per_channel=2, seed=seed, sign=False)
    return RG.from_store(RS.load_store(p))


def _route_waves(g, n_waves, seed=7):
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        wave = []
        for _ in range(Q):
            a, b = rng.choice(g.n_nodes, 2, replace=False)
            wave.append((bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                         int(rng.integers(1_000, 10_000_000))))
        waves.append(wave)
    return waves


def _mcf_waves(g, n_waves, seed=9):
    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        wave = []
        for _ in range(Q):
            a, b = rng.choice(g.n_nodes, 2, replace=False)
            wave.append((bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                         int(rng.integers(10_000, 2_000_000))))
        waves.append(wave)
    return waves


def _canon(r):
    if isinstance(r, BaseException):
        return type(r).__name__, str(r)
    if isinstance(r, tuple):          # (route, src_info)
        return "ok", [(h.node_id, h.scid, h.direction, h.amount_msat,
                       h.delay) for h in r[0]], r[1]
    return "ok", r


class _Run:
    """One package's run: per-wave results, flight records, breaker
    transitions and the metric snapshots around it."""

    def __init__(self, obs, fl, bus, family):
        self.obs, self.fl, self.bus, self.family = obs, fl, bus, family
        self.transitions: list = []
        self.results: list = []

    def _tap(self, p):
        if p["family"] == self.family:
            self.transitions.append((p["to"], p["consecutive_failures"]))

    def __enter__(self):
        self.bus.subscribe("breaker_transition", self._tap)
        self.s0 = self.obs.snapshot()
        return self

    def __exit__(self, *exc):
        self.s1 = self.obs.snapshot()
        self.bus.unsubscribe("breaker_transition", self._tap)
        self.records = sorted(self.fl.recent(self.family),
                              key=lambda r: r["dispatch_id"])

    def delta(self, name, **labels):
        def val(snap):
            fam = snap["metrics"].get(name, {"samples": []})
            return sum(s.get("value", s.get("count", 0))
                       for s in fam["samples"]
                       if all(s["labels"].get(k) == v
                              for k, v in labels.items()))
        return val(self.s1) - val(self.s0)


async def _waves(svc, waves, call, fi, spec, until, before_wave=None):
    """The waves through ``svc``, one flush each, with ``spec`` armed
    (in the package's faultinject ``fi``) for the waves before
    ``until``."""
    svc.start()
    out = []
    try:
        with fi.arm(spec) as specs:
            for i, wave in enumerate(waves):
                if i == until:
                    for sp in specs:
                        fi._armed.remove(sp)
                    specs.clear()
                if before_wave is not None:
                    before_wave(i)
                out.append(await asyncio.gather(
                    *(call(svc, *q) for q in wave), return_exceptions=True))
    finally:
        await svc.close()
    return out


def _route_call(svc, a, b, amt):
    return svc.getroute(a, b, amt, with_source=True)


def _mcf_call(svc, a, b, amt):
    return svc.getroutes(a, b, amt)


def _drive(family, make_ref, make_port, waves, spec, until, call,
           before_wave=None):
    """The same waves through both packages, ``spec`` armed for the
    waves before ``until``; returns (jax run, port run)."""
    runs = []
    for mod_obs, fl, bus, fi, make in (
            (JO, JFL, JEV, JFI, make_ref), (TO, TFL, TEV, TFI, make_port)):
        with _Run(mod_obs, fl, bus, family) as run:
            run.results = asyncio.run(_waves(make(), waves, call, fi, spec,
                                             until, before_wave))
        runs.append(run)
    return runs


SHARED = ("clntpu_breaker_failures_total",
          "clntpu_breaker_short_circuits_total",
          "clntpu_fault_injected_total", "clntpu_deadline_exceeded_total")


def _hold(family, jr, tr, exc_for):
    """The comparison every case makes; ``exc_for(port outcome)`` is the
    exception type the port's failed queries carry."""
    assert tr.transitions == jr.transitions
    assert [r["outcome"] for r in tr.records] == [
        _expected(r) for r in jr.records]
    assert len(tr.records) == len(jr.results)
    for rec, jres, tres in zip(tr.records, jr.results, tr.results):
        if rec["outcome"] == "ok":
            assert [_canon(r) for r in tres] == [_canon(r) for r in jres]
        else:
            exc = exc_for(rec["outcome"])
            assert all(type(r) is exc for r in tres), tres
            assert not any(isinstance(r, BaseException) for r in jres)
            if exc is TB.BreakerOpen:
                assert all(r.retry_in_s > 0 for r in tres)
        assert rec["n_real"] == len(tres)
    assert [(r["faults"], r["breaker_state"], r["n_real"], r["lanes"])
            for r in tr.records] == [
        (r["faults"], r["breaker_state"], r["n_real"], r["lanes"])
        for r in jr.records]
    for name in SHARED:
        assert tr.delta(name, family=family) == jr.delta(name,
                                                         family=family), name
    for to in ("open", "half_open", "closed"):
        assert tr.delta("clntpu_breaker_transitions_total", family=family,
                        to=to) == jr.delta("clntpu_breaker_transitions_total",
                                           family=family, to=to)
    for port_oc in ("ok", "error", "breaker", "deadline"):
        want = sum(1 for r in jr.records if _expected(r) == port_oc)
        assert tr.delta("clntpu_dispatches_total", family=family,
                        outcome=port_oc) == want
    for suffix in ("batch_queries", "batch_occupancy_ratio",
                   "flush_seconds"):
        name = f"clntpu_{family}_{suffix}"
        assert tr.delta(name) == jr.delta(name), name
    queries = f"clntpu_{family}_queries_total"
    for outcome in ("ok", "noroute"):
        assert tr.delta(queries, path="device", outcome=outcome) == \
            jr.delta(queries, path="device", outcome=outcome)
    failed = sum(len(t) for rec, t in zip(tr.records, tr.results)
                 if rec["outcome"] != "ok")
    assert tr.delta(queries, path="device", outcome="error") == failed
    assert jr.delta(queries, path="host") == failed
    assert tr.delta(queries, path="host") == 0
    assert tr.delta(f"clntpu_{family}_fallback_total") == 0


def _exc(outcome):
    return {"error": TFI.FaultInjected, "breaker": TB.BreakerOpen,
            "deadline": TDL.DeadlineExceeded}[outcome]


def _recover(i, at):
    """Before wave ``at`` (faults disarmed): wait out the breaker's
    backoff, so that wave is the half-open probe."""
    if i == at:
        time.sleep(max(TB.get("route").retry_in_s(),
                       TB.get("mcf").retry_in_s(),
                       JB.get("route").snapshot().get("retry_in_s", 0),
                       JB.get("mcf").snapshot().get("retry_in_s", 0))
                   + 0.05)


@pytest.mark.parametrize("spec,n_waves,recover", [
    ("dispatch:route:raise:1.0", 8, 7),
    ("dispatch:route:raise:0.5", 6, None)])
def test_route_service_under_faults_matches_jax_package(
        ref, tmp_path, spec, n_waves, recover):
    """raise:1.0 fails five flushes ("error"), the fifth opens the
    breaker, the next two are refused on it ("breaker", R1 not
    launched); disarmed, after the backoff, a half-open probe closes
    it.  raise:0.5 fails every other flush and never opens it."""
    rd = ref[0]
    g = _net(tmp_path, 100, 40, 3)
    tg = convert.gossmap(g)
    calls = []
    real = TD.solve_batch

    def counted(*a, **kw):
        calls.append(len(a[1]))
        return real(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "solve_batch", counted)
        jr, tr = _drive(
            "route",
            lambda: rd.RouteService(lambda: g, flush_ms=20.0, batch=Q,
                                    host_max=0, device=True),
            lambda: TD.RouteService(lambda: tg, device=CPU, batch=Q,
                                    flush_ms=20.0),
            _route_waves(g, n_waves), spec, recover, _route_call,
            before_wave=(lambda i: _recover(i, recover)) if recover
            else None)
    _hold("route", jr, tr, _exc)
    outcomes = [r["outcome"] for r in tr.records]
    if recover is not None:
        assert outcomes == ["error"] * 5 + ["breaker"] * 2 + ["ok"]
        assert [t[0] for t in tr.transitions] == ["open", "half_open",
                                                  "closed"]
    else:
        assert outcomes == ["ok", "error"] * 3 and tr.transitions == []
    # the card (here R1's plain version) ran for the "ok" flushes only:
    # the seam raises before the dispatch, the breaker refuses it
    assert calls == [Q] * outcomes.count("ok")


def test_mcf_service_under_faults_matches_jax_package(ref, tmp_path):
    """dispatch:mcf:raise:1.0 on McfService: five "error" flushes, the
    breaker opens, two "breaker" flushes, then a half-open probe closes
    it; the failed queries count as quarantined rows in both."""
    md = ref[1]
    g = _net(tmp_path, 30, 20, 17)
    tg = convert.gossmap(g)
    jr, tr = _drive(
        "mcf",
        lambda: md.McfService(lambda: g, flush_ms=20.0, batch=Q,
                              host_max=0, device=True),
        lambda: TM.McfService(lambda: tg, device=CPU, batch=Q,
                              flush_ms=20.0),
        _mcf_waves(g, 8), "dispatch:mcf:raise:1.0", 7, _mcf_call,
        before_wave=lambda i: _recover(i, 7))
    _hold("mcf", jr, tr, _exc)
    assert [r["outcome"] for r in tr.records] == \
        ["error"] * 5 + ["breaker"] * 2 + ["ok"]
    assert tr.delta("clntpu_quarantine_total", family="mcf") == \
        jr.delta("clntpu_quarantine_total", family="mcf") == 5 * Q
    # parts are counted for every answer: the port's device answers are
    # the JAX package's
    assert tr.delta("clntpu_mcf_parts_per_query") == jr.delta(
        "clntpu_mcf_queries_total", path="device", outcome="ok")


def test_a_hung_dispatch_blows_the_deadline_like_the_jax_package(
        ref, tmp_path, monkeypatch):
    """dispatch:route:hang:1:0.3 with a 0.1 s deadline: the flush records
    "deadline" and its queries fail with DeadlineExceeded (the JAX
    package re-solves them on the host); the next flush, disarmed, is
    "ok"."""
    rd = ref[0]
    g = _net(tmp_path, 100, 40, 11)
    tg = convert.gossmap(g)
    monkeypatch.setenv("LIGHTNING_TPU_DEADLINE_ROUTE_S", "0.1")
    real = rd.solve_batch

    def hung_once(*a, **kw):
        if not hung_once.done:
            hung_once.done = True
            time.sleep(0.3)
        return real(*a, **kw)
    hung_once.done = False
    monkeypatch.setattr(rd, "solve_batch", hung_once)
    jr, tr = _drive(
        "route",
        lambda: rd.RouteService(lambda: g, flush_ms=20.0, batch=Q,
                                host_max=0, device=True),
        lambda: TD.RouteService(lambda: tg, device=CPU, batch=Q,
                                flush_ms=20.0, deadline_s=0.1),
        _route_waves(g, 2, seed=5), "dispatch:route:hang:1:0.3", 1,
        _route_call)
    _hold("route", jr, tr, _exc)
    assert [r["outcome"] for r in tr.records] == ["deadline", "ok"]
    assert tr.delta("clntpu_deadline_exceeded_total", family="route",
                    seam="dispatch") == 1
