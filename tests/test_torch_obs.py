"""The port's observability spine against the JAX package's.

The same declarations, increments and observations give the same
snapshot and the same Prometheus text byte for byte; the flight ring,
trace spans and the log ring give records of the same shape for the same
calls.  The port's torch hooks (``profile_session``, ``annotation``) are
checked on the CPU."""
from __future__ import annotations

import json
import logging
import os

import numpy as np
import pytest
import torch

import lightning_tpu.gossip.ingest as JI
import lightning_tpu.gossip.verify as JV
from lightning_tpu import obs as JO
from lightning_tpu.obs import families as JF
from lightning_tpu.obs import flight as JFL
from lightning_tpu.obs import registry as JR
from lightning_tpu.utils import logring as JLR
from lightning_tpu.utils import trace as JT

import lightning_tpu_torch.daemon.hsmd  # noqa: F401  (declares sign families)
import lightning_tpu_torch.gossip.ingest as TI
import lightning_tpu_torch.gossip.store  # noqa: F401
import lightning_tpu_torch.gossip.verify as TV
from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.obs import families as TF
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.obs import registry as TR
from lightning_tpu_torch.utils import logring as TLR
from lightning_tpu_torch.utils import trace as TT

torch.set_num_threads(1)


def _declared(mods, reg_mod) -> dict:
    """name -> Family over the module-level instruments of `mods` (the
    registry itself may have been reset by another test in the process;
    the instruments keep their declarations)."""
    out = {}
    for m in mods:
        for v in vars(m).values():
            if isinstance(v, reg_mod.Family):
                out[v.name] = v
    return out


def _port_families():
    return _declared([TF, TV, TI, TO._collector], TR)


def _jax_families():
    return _declared([JF, JV, JI, JO._collector], JR)


def test_every_port_family_is_declared_as_the_jax_package_declares_it():
    port, jax = _port_families(), _jax_families()
    assert {"clntpu_replay_prep_seconds_total",
            "clntpu_replay_prep_stall_seconds_total",
            "clntpu_replay_dispatch_seconds_total",
            "clntpu_replay_readback_seconds_total",
            "clntpu_replay_overlap_ratio", "clntpu_transfer_bytes_total",
            "clntpu_breaker_state", "clntpu_quarantine_total",
            "clntpu_fault_injected_total", "clntpu_deadline_exceeded_total",
            "clntpu_loop_restarts_total", "clntpu_ingest_flush_errors_total",
            "clntpu_shed_total", "clntpu_overload_state", "clntpu_sign_total",
            "clntpu_dispatches_total", "clntpu_verify_flush_seconds",
            "clntpu_gossip_flush_seconds"} <= set(port)
    for name, fam in port.items():
        ref = jax[name]
        assert (fam.kind, fam.help, fam.labelnames, fam.buckets,
                fam.max_label_sets) == (ref.kind, ref.help, ref.labelnames,
                                        ref.buckets, ref.max_label_sets), name
    # the live registry holds them (present at zero before any dispatch)
    live = TO.snapshot()["metrics"]
    assert set(port) <= set(live)


def _drive(reg_mod, fams: dict, seed: int):
    """One fresh registry of `reg_mod` with `fams` declared, and the same
    seeded sequence of increments and observations on it."""
    reg = reg_mod.Registry()
    made = {}
    for name in sorted(fams):
        f = fams[name]
        if f.kind == "histogram":
            made[name] = reg.histogram(name, f.help, f.labelnames,
                                       buckets=f.buckets)
        else:
            made[name] = getattr(reg, f.kind)(name, f.help, f.labelnames)
    rng = np.random.default_rng(seed)
    values = ["verify", "sign", "a\"b", "back\\slash", "new\nline", "0",
              "host_breaker"]
    for name in sorted(made):
        fam = made[name]
        n_sets = 70 if name == "clntpu_shed_total" else 4   # past the cap
        for k in range(n_sets):
            labels = tuple(values[int(rng.integers(len(values)))] + str(k % 9)
                           if j else values[k % len(values)] + str(k)
                           for j in range(len(fam.labelnames)))
            child = fam.labels(*labels) if fam.labelnames else fam
            for _ in range(3):
                v = float(rng.choice([0.0, 1.0, 2.5, 1e-7, 3e3, 1e20,
                                      float(rng.random())]))
                if fam.kind == "counter":
                    child.inc(v)
                elif fam.kind == "gauge":
                    (child.set, child.inc, child.dec)[
                        int(rng.integers(3))](v)
                else:
                    child.observe(v)
    return reg


def test_same_observations_give_the_same_snapshot_and_prometheus_text():
    port = _port_families()
    jax = {n: f for n, f in _jax_families().items() if n in port}
    for seed in (1, 2):
        t, j = _drive(TR, port, seed), _drive(JR, jax, seed)
        assert t.snapshot() == j.snapshot()
        text = t.render_prometheus()
        assert text == j.render_prometheus()
        assert 'le="+Inf"' in text and "<other>" in text


def _strip(rec: dict) -> dict:
    """A record without its clock readings and ids (the dispatch() form
    measures its own dispatch_ms)."""
    drop = {"ts", "ts_ns", "tid", "dispatch_id", "parent_dispatch_id",
            "dispatch_ms"}
    return {k: v for k, v in rec.items() if k not in drop}


def _flight_sequence(fl, slow_on):
    fl.reset_for_tests()
    r1 = fl.begin("verify", corr_ids=[3, 4], shape=(8, 4), n_real=5,
                  lanes=8, queue_wait_ms=1.5, prep_ms=2.25,
                  breaker_state="closed")
    fl.note_fault("dispatch", "verify")
    fl.note_quarantine(2)
    r1["outcome"] = "bisect"
    fl.defer(r1)
    assert fl.current() is None
    r2 = fl.begin("sign", n_real=3, lanes=3, shape=(3, 32))
    inner = fl.begin("check", n_real=1, lanes=1)
    assert inner["parent_dispatch_id"] == r2["dispatch_id"]
    fl.finish(inner, "host", dispatch_ms=0.5, error="FaultInjected")
    fl.finish(r2, "ok", dispatch_ms=1.25)
    fl.finish(r1, dispatch_ms=3.5)
    fl.finish(r1, "error")               # idempotent: stays "bisect"
    assert (r1["dispatch_ms"], r2["dispatch_ms"]) == (3.5, 1.25)
    with fl.dispatch("check", n_real=2, lanes=2) as r3:
        r3["outcome"] = "host"
    with pytest.raises(ValueError):
        with fl.dispatch("verify", n_real=1, lanes=1):
            raise ValueError("boom")
    slow_on()
    for i in range(5):                    # past a ring of 3; slow at 1 ms
        fl.finish(fl.begin("verify", n_real=i, lanes=8, prep_ms=5.0),
                  dispatch_ms=0.0)
    recs = {fam: [_strip(r) for r in fl.recent(fam)]
            for fam in ("verify", "sign", "check")}
    recs["all"] = [_strip(r) for r in fl.recent(limit=4)]
    summ = fl.summary()
    for fam in summ["families"].values():
        fam["last"] = _strip(fam["last"])
    return recs, summ


def test_flight_ring_gives_the_jax_package_records(monkeypatch):
    monkeypatch.setenv("LIGHTNING_TPU_FLIGHT_RING", "3")
    monkeypatch.setattr(TFL, "RING_SIZE", 3)
    try:
        t = _flight_sequence(TFL, lambda: monkeypatch.setattr(
            TFL, "SLOW_DISPATCH_S", 0.001))
        j = _flight_sequence(JFL, lambda: monkeypatch.setenv(
            "LIGHTNING_TPU_SLOW_DISPATCH_S", "0.001"))
    finally:
        TFL.reset_for_tests()
        JFL.reset_for_tests()
    assert t == j
    assert [r["outcome"] for r in t[0]["verify"]] == ["ok"] * 3
    assert all(r.get("slow") for r in t[0]["verify"])
    assert t[0]["check"][0]["error"] == "FaultInjected"


def _span_shapes(tr):
    tr.set_sink(None)
    tr.reset()
    with tr.span("outer", a=1):
        c = tr.new_corr()
        with tr.span("inner", corr=[c, "not a carrier"], dispatch_id=7,
                     b="x"):
            pass
    with pytest.raises(KeyError):
        with tr.span("err", corr=c):
            raise KeyError("k")
    out = []
    for r in tr.records():
        out.append({"keys": sorted(r), "name": r["name"],
                    "parent": r["parent"],
                    "has_parent_id": r["parent_id"] is not None,
                    "n_corr": len(r.get("corr_ids", [])),
                    "attributes": r.get("attributes"),
                    "error": r.get("error"),
                    "dispatch_id": r.get("dispatch_id")})
    summ = {k: sorted(v) for k, v in tr.summarize().items()}
    assert len(tr.as_carriers(None)) == 0 and tr.as_carriers(c) == (c,)
    tr.reset()
    return out, summ


def test_spans_and_carriers_have_the_jax_package_shape():
    assert _span_shapes(TT) == _span_shapes(JT)


def test_span_durations_reach_the_registry():
    def count(snap):
        fam = snap["metrics"]["clntpu_span_duration_seconds"]
        return sum(s["count"] for s in fam["samples"]
                   if s["labels"]["name"] == "obs-test/span")

    before = count(TO.snapshot())
    with TT.span("obs-test/span"):
        pass
    assert count(TO.snapshot()) == before + 1
    TT.reset()


def test_log_ring_matches_the_jax_package():
    def drive(lr, prefix):
        ring = lr.LogRing(max_entries=4, default_level="info")
        ring.set_level("debug:gossipd")
        lg, other = (logging.getLogger(prefix + n)
                     for n in (".gossipd", ".other"))
        levels = lg.level, other.level
        for x in (lg, other):
            x.addHandler(ring)
            x.setLevel(1)
        try:
            lg.debug("kept %d", 1)
            other.debug("skipped")
            ring.add("hsmd", "signed", "unusual")
            ring.add("hsmd", "io line", "io")
            for i in range(4):
                ring.add("verify", f"bucket {i}", "broken")
        finally:
            for x, level in zip((lg, other), levels):
                x.removeHandler(ring)
                x.setLevel(level)
        got = ring.getlog("io")
        for e in got["log"]:
            e.pop("time")
        got.pop("created_at")
        return got, ring.n_skipped, ring.n_emitted

    assert drive(TLR, "lightning_tpu_torch") == drive(JLR, "lightning_tpu")


def test_annotation_is_a_no_op_outside_a_session(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("record_function outside a session")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    with TT.annotation("verify/dispatch", "cpu"):
        pass
    with TT.profile_session(None) as path:
        assert path is None
        with TT.annotation("verify/dispatch"):
            pass


def test_profile_session_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with TT.profile_session(d) as path:
        with TT.profile_session(d) as nested:
            assert nested is None
        with TT.annotation("verify/dispatch", "cpu"):
            torch.ones(16).sum()
        with TT.device_span("replay", profile_dir=d, n=1):   # nested no-op
            pass
    assert path is not None and os.path.dirname(path) == d
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "verify/dispatch" in names
    assert os.listdir(d) == [os.path.basename(path)]
    assert [r["name"] for r in TT.records()][-1:] == ["replay"]
    TT.reset()
