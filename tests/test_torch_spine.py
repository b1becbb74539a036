"""The port's observability spine against the JAX package's: journeys,
perf attribution, the health engine, the Chrome-trace export and the
incident recorder, fed the same synthetic inputs (hops, flight records,
span records, metric observations, bus events) on the same injected
clocks.  Outputs must be equal up to the fields each test names:

* journeys: ``seq`` (a process-wide counter) and the span records' tid
  and span_id derived from it;
* attribution: ``generated_at``; retrace events' ``ts``;
* health: ``since``, ``last_tick_at`` (wall clock) and ``running``;
  transition events' ``ts``;
* incident manifests: ``id`` and every wall-clock time (``at``,
  ``opened_at``, ``captured_at``, ``capture_ms``), ``process``, the
  artifacts' byte sizes; the open breaker's ``retry_in_s``; the
  artifacts ``metrics.json`` (each package's registry declares other
  families) and ``knobs.json`` (the JAX package's lists its environment
  variables, the port's its constants and arguments) are checked for
  presence only.
"""
from __future__ import annotations

import copy
import json
import os
import threading

import pytest

from lightning_tpu.obs import attribution as JA
from lightning_tpu.obs import flight as JFL
from lightning_tpu.obs import health as JH
from lightning_tpu.obs import incident as JI
from lightning_tpu.obs import journey as JJ
from lightning_tpu.obs import registry as JR
from lightning_tpu.obs import traceexport as JX
from lightning_tpu.resilience import breaker as JB
from lightning_tpu.resilience import overload as JOV
from lightning_tpu.utils import events as JEV
from lightning_tpu.utils import trace as JT
from lightning_tpu_torch.obs import attribution as TA
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.obs import health as TH
from lightning_tpu_torch.obs import incident as TI
from lightning_tpu_torch.obs import journey as TJ
from lightning_tpu_torch.obs import registry as TR
from lightning_tpu_torch.obs import traceexport as TX
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import overload as TOV
from lightning_tpu_torch.utils import events as TEV
from lightning_tpu_torch.utils import trace as TT

JAX = dict(J=JJ, A=JA, H=JH, X=JX, I=JI, R=JR, B=JB, EV=JEV, T=JT, FL=JFL)
PORT = dict(J=TJ, A=TA, H=TH, X=TX, I=TI, R=TR, B=TB, EV=TEV, T=TT, FL=TFL)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """The subsystems the reports and bundles read are process-global:
    other tests of the worker leave breakers, flight rings and overload
    controllers behind, in one package or the other."""
    for k in ("LIGHTNING_TPU_JOURNEY_SAMPLE", "LIGHTNING_TPU_JOURNEY_MAX",
              "LIGHTNING_TPU_JOURNEY_HOPS"):
        monkeypatch.delenv(k, raising=False)
    mods = (JJ, JA, JB, JFL, JH, JI, JOV, TJ, TA, TB, TFL, TH, TI, TOV)
    for m in mods:
        m.reset_for_tests()
    yield
    monkeypatch.undo()
    for m in mods:
        m.reset_for_tests()


def _sampling(monkeypatch, sample, max_entities=512, hops=64):
    monkeypatch.setenv("LIGHTNING_TPU_JOURNEY_SAMPLE", str(sample))
    monkeypatch.setenv("LIGHTNING_TPU_JOURNEY_MAX", str(max_entities))
    monkeypatch.setenv("LIGHTNING_TPU_JOURNEY_HOPS", str(hops))
    JJ.reset_for_tests()
    TJ.configure(sample, max_entities, hops)


def _drop(obj, keys):
    """``obj`` with every dict key in ``keys`` removed, at any depth."""
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, (list, tuple)):
        return [_drop(v, keys) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# journeys


def _journey_feed(J):
    t = 1_000_000_000
    for i in range(40):
        scid = (700_000 << 40) | (i << 16)
        J.hop("admit", "channel", scid, outcome="ok", corr_id=i, t_ns=t + i,
              queued_sigs=i)
        J.hop("verify", "channel", scid, outcome="ok" if i % 7 else
              "bad_signature", wait_s=0.001 * i, service_s=0.02,
              dispatch_id=100 + i // 8, corr_id=i, t_ns=t + 10_000 + i)
        if i % 7 == 0:
            J.hop("drop", "channel", scid, outcome="bad_signature",
                  t_ns=t + 20_000 + i)
        else:
            J.hop("store", "channel", scid, outcome="ok", service_s=0.003,
                  corr_id=i, t_ns=t + 30_000 + i)
    for n in range(5):
        key = bytes([n]) * 32
        for h in ("enqueue", "mcf_flush", "parts", "htlc_add", "htlc_add",
                  "htlc_settle"):
            J.hop(h, "payment", key, outcome="ok", wait_s=0.0005 * n,
                  service_s=0.01, t_ns=t + 50_000 + n, parts=2)
    J.hop("recv", "node", "AB" * 33, t_ns=t + 90_000)
    J.note_batch_wait("verify", 0.25)
    J.note_batch_wait("mcf", 0.5)
    with pytest.raises(ValueError):
        J.hop("teleport", "channel", 1)
    with pytest.raises(ValueError):
        J.note_batch_wait("sign", 1.0)
    return {
        "enabled": J.enabled(),
        "sampled": [J.sampled("channel", s) for s in range(300)]
        + [J.sampled("payment", bytes([n]) * 32) for n in range(40)],
        "canon": [J.canon_key("channel", "12"),
                  J.canon_key("payment", b"\xab" * 4),
                  J.canon_key("node", "AbCd")],
        "lookup": J.lookup("channel", (700_000 << 40) | (7 << 16)),
        "lookup_none": J.lookup("channel", 5),
        "recent": J.recent(limit=12),
        "summary": J.summary(),
        "p99": J.e2e_p99_ms(),
        "spans": J.journey_span_records(limit=6),
    }


@pytest.mark.parametrize("sample,max_entities,hops", [
    (1, 512, 64), (3, 16, 3), (0, 512, 64)])
def test_journeys_match_jax_package(monkeypatch, sample, max_entities,
                                    hops):
    """Sampling off, every entity, and 1 in 3 with a 16-entity LRU table
    and 3 hops a journey (eviction and truncation)."""
    _sampling(monkeypatch, sample, max_entities, hops)
    want, got = _journey_feed(JJ), _journey_feed(TJ)
    drop = {"seq", "tid", "span_id"}
    assert _drop(got, drop) == _drop(want, drop)
    if sample == 1:
        assert got["summary"]["entities"] == 46
    elif sample == 0:
        assert got["recent"] == [] and not got["enabled"]


# ---------------------------------------------------------------------------
# attribution


def _records(n=12):
    recs = []
    for i in range(n):
        recs.append({
            "dispatch_id": i + 1, "family": "route" if i % 3 else "verify",
            "ts_ns": 5_000_000_000 + i * 40_000_000,
            "queue_wait_ms": 0.5 * i, "prep_ms": 1.25 + i,
            "dispatch_ms": 7.5 + 0.25 * i, "readback_ms": 2.0 if i % 2
            else None, "h2d_bytes": 1000 * i, "d2h_bytes": 64 * i,
            "n_real": 50 + i, "lanes": 64, "quarantined": i % 5 == 0,
            "outcome": ("ok", "error", "breaker", "ok")[i % 4],
            "faults": [], "corr_ids": [i], "tid": 7, "thread": "loop",
        })
    return recs


def _attribution(A, recs):
    verify = [r for r in recs if r["family"] == "verify"]
    route = [r for r in recs if r["family"] == "route"]
    totals = {"prep": 0.05, "stall": 0.01, "dispatch": 0.03,
              "readback": 0.004}
    metrics = {
        "clntpu_replay_prep_seconds_total": {"samples": [{"value": 0.05}]},
        "clntpu_replay_prep_stall_seconds_total":
            {"samples": [{"value": 0.01}]},
        "clntpu_replay_dispatch_seconds_total":
            {"samples": [{"value": 0.03}]},
        "clntpu_replay_readback_seconds_total":
            {"samples": [{"value": 0.004}]},
    }
    snap = {"metrics": metrics, "dispatch_log": recs,
            "dispatches": {"families": {"route": {"total": 8},
                                        "verify": {"total": 99}}}}
    rep = A.report_from_snapshot(snap, kernel_rate=4096.0)
    A.note_program("route", (64, 256, 8, 20))
    with A.warmup_scope():
        A.note_program("mcf", (64, 256, 8))
    fired = [A.note_program("route", (64, 256, 8, 20)),
             A.note_program("route", (128, 512, 8, 20)),
             A.note_program("mcf", [64, 512, 8])]
    return {
        "serial": A.attribute_family("route", route),
        "overlapped": A.attribute_family("verify", verify,
                                         stage_totals_s=totals,
                                         kernel_rate=2048.0),
        "incomplete": A.attribute_family("verify", verify,
                                         stage_totals_s=totals,
                                         ring_complete=False),
        "empty": A.attribute_family("sign", []),
        "totals": A.replay_stage_totals(metrics),
        "no_totals": A.replay_stage_totals({}),
        "report": rep,
        "compact": A.compact(rep),
        "fired": fired,
        "retraces": A.retrace_state(),
        "memory": A.sample_device_memory(),
    }


def test_attribution_matches_jax_package():
    recs = _records()
    want = _attribution(JA, copy.deepcopy(recs))
    got = _attribution(TA, copy.deepcopy(recs))
    drop = {"generated_at", "ts"}
    assert _drop(got, drop) == _drop(want, drop)
    assert got["fired"] == [False, True, True]
    assert got["report"]["families"]["verify"]["roofline"]["gap_x"] > 0
    assert got["memory"] == {}     # CUDA is not initialised here


# ---------------------------------------------------------------------------
# health


def _health_run(P):
    """One engine over a registry of its package's, ticked on one
    injected clock through quiet, a slow-route burst, an open breaker
    and a blown deadline, then recovery."""
    reg = P["R"].Registry()
    answer = reg.histogram("clntpu_route_answer_seconds", "a",
                           buckets=P["R"].DURATION_BUCKETS)
    sigs = reg.histogram("clntpu_gossip_flush_sigs", "s",
                         buckets=P["R"].SIZE_BUCKETS)
    accepted = reg.counter("clntpu_gossip_accepted_total", "a")
    shed = reg.counter("clntpu_shed_total", "s", labelnames=("family",))
    deadline = reg.counter("clntpu_deadline_exceeded_total", "d",
                           labelnames=("family", "seam"))
    state = reg.gauge("clntpu_overload_state", "o",
                      labelnames=("family",))
    clock = {"t": 100.0}
    eng = P["H"].HealthEngine(interval_s=5.0, ring=16, short_ticks=2,
                              long_ticks=4, recover_ticks=2, registry=reg,
                              now=lambda: clock["t"])
    seen = []
    taps = [(topic, (lambda p, topic=topic: seen.append((topic, p))))
            for topic in ("slo_breach", "health_state")]
    for topic, fn in taps:
        P["EV"].subscribe(topic, fn)
    reports = []
    try:
        for step in range(14):
            if step in (2, 3):
                for _ in range(50):
                    answer.observe(3.5)
            if 1 <= step <= 5:
                accepted.inc(100)
                sigs.observe(120)
                shed.labels("verify").inc(2)
            if step == 4:
                P["B"].get("route").force_open()
            if step == 6:
                deadline.labels("route", "dispatch").inc()
                state.labels("route").set(2.0)
            if step == 8:
                P["B"].get("route").reset()
                state.labels("route").set(0.0)
            eng.tick()
            clock["t"] += 5.0 if step != 5 else 3.0
            reports.append(eng.report(series=["clntpu_shed_total"],
                                      points=4))
    finally:
        for topic, fn in taps:
            P["EV"].unsubscribe(topic, fn)
    return {"reports": reports, "events": seen,
            "compact": P["H"].compact(reports[-1]),
            "state": eng.state_name(), "empty": P["H"].empty_report(),
            "default_slo": P["H"].DEFAULT_SLO,
            "quantile": [P["H"].estimate_quantile(
                [1.0, 2.0, 4.0, 8.0], [3, 0, 5, 1], 2.0, q)
                for q in (0.0, 0.5, 0.9, 0.99, 1.0)]}


def test_health_engine_matches_jax_package():
    """The reports tick by tick (SLO statuses, burn rates, observed
    values, the roll-up state, the breaker view, series rings), the
    breach and state events, and the quantile estimate."""
    want, got = _health_run(JAX), _health_run(PORT)
    drop = {"since", "last_tick_at", "running", "ts"}
    assert _drop(got, drop) == _drop(want, drop)
    states = [r["state"] for r in got["reports"]]
    assert "degraded" in states or "unhealthy" in states
    assert states[-1] == "healthy"
    breached = {s for r in got["reports"] for s in r["breached"]}
    assert {"route_p99", "breaker_open", "deadline_rate"} <= breached
    assert {spec.name for spec in TH.default_slo_specs()} == {
        spec.name for spec in JH.default_slo_specs()}
    eng = TH.ensure_engine(interval_s=1.0)
    assert TH.current() is eng and TH.ensure_engine() is eng
    assert TH.install(None) is None and TH.current() is None


# ---------------------------------------------------------------------------
# the Chrome-trace export


def _spans():
    base = 2_000_000_000
    recs = []
    for i in range(6):
        recs.append({"name": "route/enqueue", "start_ns": base + i * 1000,
                     "duration_ns": 500, "tid": 11, "thread": "loop",
                     "span_id": 10 + i, "parent_id": None,
                     "corr_ids": [i + 1], "attributes": {"i": i}})
    recs.append({"name": "route/flush", "start_ns": base + 10_000,
                 "duration_ns": 80_000, "tid": 11, "thread": "loop",
                 "span_id": 30, "parent_id": None,
                 "corr_ids": [1, 2, 3, 4, 5, 6], "dispatch_id": 9,
                 "attributes": {"queries": 6}})
    recs.append({"name": "verify/dispatch", "start_ns": base + 20_000,
                 "duration_ns": 1000, "tid": 12, "thread": "worker",
                 "span_id": 31, "parent_id": 30, "corr_ids": [7],
                 "error": "FaultInjected"})
    recs.append({"name": "no-start"})
    flights = [dict(r, ts_ns=2_000_010_000 + 100 * i)
               for i, r in enumerate(_records(4))]
    return recs, flights


def test_trace_export_matches_jax_package():
    spans, flights = _spans()
    for pid in (1, 4):
        want = JX.chrome_trace(copy.deepcopy(spans), copy.deepcopy(flights),
                               pid=pid)
        got = TX.chrome_trace(copy.deepcopy(spans), copy.deepcopy(flights),
                              pid=pid)
        assert got == want
        assert TX.validate(got) == JX.validate(want) == []
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "ts": 1, "pid": 1, "tid": 1, "dur": -1},
        {"ph": "s", "name": "corr", "id": 3, "ts": 50, "pid": 1, "tid": 9},
        {"ph": "f", "name": "corr", "id": 3, "ts": 5, "pid": 1, "tid": 1},
        {"ph": "Q"}, "junk", {"ph": "M", "args": {}}]}
    assert TX.validate(bad) == JX.validate(bad) != []
    assert TX.validate([]) == JX.validate([])
    assert TX.validate({}) == JX.validate({})


# ---------------------------------------------------------------------------
# the incident recorder


MANIFEST_DROP = {"id", "at", "opened_at", "captured_at", "capture_ms",
                 "process", "bytes", "total_bytes", "retry_in_s", "_dir",
                 "age_s", "dir", "ts"}


def _bundle(directory, bid):
    out = {}
    for name in sorted(os.listdir(os.path.join(directory, bid))):
        with open(os.path.join(directory, bid, name), encoding="utf8") as f:
            out[name] = json.load(f)
    return out


def _incident_run(P, directory, monkeypatch):
    spans, flights = _spans()
    monkeypatch.setattr(P["T"], "records", lambda: copy.deepcopy(spans))
    monkeypatch.setattr(P["FL"], "recent",
                        lambda family=None, limit=None: copy.deepcopy(
                            flights))
    monkeypatch.setattr(P["FL"], "summary", lambda: {
        "ring_size": 256, "families": {"route": {"total": 3, "ring": 3,
                                                 "last": None}}})
    P["J"].hop("enqueue", "payment", b"\x01" * 32, t_ns=5, corr_id=3)
    P["J"].hop("parts", "payment", b"\x01" * 32, t_ns=9, parts=2)
    clock = {"t": 50.0}
    rec = P["I"].IncidentRecorder(directory, max_bundles=1, cooldown_s=30.0,
                                  now=lambda: clock["t"])
    P["I"].install(rec)
    rec.start()
    ev = P["EV"]
    try:
        ev.emit("deadline_exceeded", {"family": "route", "seam": "dispatch",
                                      "deadline_s": 0.1})
        P["B"].get("route").force_open()
        ev.emit("slo_breach", {"slo": "breaker_open", "kind": "breaker_open",
                               "window": "short", "severity": "major",
                               "observed": 6.0, "breaches_total": 1})
        ev.emit("health_state", {"state": "healthy", "breached": []})
        ev.emit("quarantine", {"family": "mcf", "row": 3,
                               "reason": "FaultInjected"})
        assert rec.drain(10.0)
        first = rec.summary()["incidents"]
        bid = first[0]["id"]
        bundle1 = _bundle(directory, bid)
        clock["t"] += 31.0
        ev.emit("slow_dispatch", {"family": "mcf", "dispatch_id": 4,
                                  "outcome": "ok"})
        assert rec.drain(10.0)
    finally:
        rec.stop()
        P["B"].get("route").reset()
    summ = rec.summary()
    bundle2 = _bundle(directory, summ["incidents"][0]["id"])
    got = rec.get(summ["incidents"][0]["id"], "trace.json")
    with pytest.raises(ValueError):
        rec.get("nope")
    with pytest.raises(ValueError):
        rec.get(summ["incidents"][0]["id"], "secrets.json")
    with pytest.raises(KeyError):
        rec.get("inc-1-999")
    assert not os.path.exists(os.path.join(directory, bid))  # rotated
    out = {"first": first, "summary": summ, "bundle1": bundle1,
           "bundle2": bundle2, "get": got["artifact"]["name"]}
    for b in (bundle1, bundle2):
        for name in ("metrics.json", "knobs.json"):
            assert isinstance(b.pop(name), dict)
    return out


def test_incident_recorder_matches_jax_package(tmp_path, monkeypatch):
    """A deadline opens an episode, the breaker opening escalates it
    (one bundle, named breaker_open, the deadline in its history), the
    SLO breach and the quarantine are absorbed, a recovering health
    state is ignored; past the cooldown a slow dispatch opens a second
    episode, and rotation (max 1 bundle) drops the first."""
    _sampling(monkeypatch, 1)
    want = _incident_run(JAX, str(tmp_path / "jax"), monkeypatch)
    got = _incident_run(PORT, str(tmp_path / "port"), monkeypatch)
    assert _drop(got, MANIFEST_DROP | {"seq"}) == \
        _drop(want, MANIFEST_DROP | {"seq"})
    man = got["bundle1"]["manifest.json"]
    assert man["trigger"]["class"] == "breaker_open"
    assert man["correlation"]["family"] == "route"
    assert [h["class"] for h in man["history"]] == ["deadline",
                                                    "breaker_open"]
    assert man["suppressed"] == {"slo_breach": 1, "quarantine": 1}
    assert sorted(man["artifacts"]) == sorted(TI.ARTIFACTS)
    assert TX.validate(got["bundle1"]["trace.json"]) == []
    assert got["summary"]["count"] == 1


def _thread_crash(P, directory):
    rec = P["I"].IncidentRecorder(directory, process_hooks=True,
                                  now=lambda: 0.0)
    rec.start()
    try:
        def boom():
            raise ValueError("worker died")
        t = threading.Thread(target=boom, name="crashing-worker")
        t.start()
        t.join()
        assert rec.drain(10.0)
    finally:
        rec.stop()
    bid = rec.summary()["incidents"][0]["id"]
    man = _bundle(directory, bid)["manifest.json"]
    man["trigger"]["payload"].pop("traceback")
    return man


def test_a_thread_crash_freezes_a_bundle_like_the_jax_package(tmp_path):
    want = _thread_crash(JAX, str(tmp_path / "jax"))
    got = _thread_crash(PORT, str(tmp_path / "port"))
    assert _drop(got, MANIFEST_DROP) == _drop(want, MANIFEST_DROP)
    assert got["trigger"]["class"] == "thread_crash"
    assert got["correlation"]["exception"] == "ValueError"


def test_knobs_list_constants_and_arguments_without_the_environment(
        tmp_path, monkeypatch):
    monkeypatch.setenv("LIGHTNING_TPU_INCIDENT_COOLDOWN_S", "1")
    rec = TI.install(str(tmp_path), cooldown_s=12.0)
    TH.install(TH.HealthEngine(interval_s=2.0))
    try:
        knobs = TI.resolve_knobs(rec)
    finally:
        TH.install(None)
        TI.install(None)
    assert knobs["obs.incident.COOLDOWN_S"] == {"value": 60.0,
                                                "source": "constant"}
    assert knobs["incident.cooldown_s"] == {"value": 12.0,
                                            "source": "argument"}
    assert knobs["health.interval_s"]["value"] == 2.0
    assert knobs["obs.flight.RING_SIZE"]["value"] == TFL.RING_SIZE
    assert not any(k.startswith("LIGHTNING_TPU") for k in knobs)
