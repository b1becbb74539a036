"""The port's supervised, pipelined replay against the JAX package's.

``verify_items`` streams self-contained buckets through a producer
thread and supervises every bucket dispatch (breaker, quarantine
bisection, fault seams, flight records).  Held here, on the CPU, with
stub dispatchers that call the exact-int oracle (no EC program of either
package is compiled) and twice with the port's real plain kernels:

* the machinery: equal verdicts at depth 0 and depth 2, the overlap
  contract of the JAX package's pipeline test at a smaller size, prep
  errors, a hung producer, no leaked thread;
* under the same fault specs: where the JAX package re-checks rows on
  the host, the port raises, and the test re-checks those rows itself;
  the verdicts, the per-bucket outcomes, the isolated rows and the
  breaker's transitions then equal the JAX package's;
* an open breaker, a quarantined row, a readback failure and a lost
  card each raise, and the host oracle is never called.
"""
from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from lightning_tpu.gossip import verify as JV
from lightning_tpu.obs import flight as JFL
from lightning_tpu.resilience import breaker as JB
from lightning_tpu.resilience import faultinject as JFI
from lightning_tpu.utils import events as JEV

from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.crypto import secp256k1 as S
from lightning_tpu_torch.gossip import synth
from lightning_tpu_torch.gossip import verify as TV
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import faultinject as TFI
from lightning_tpu_torch.resilience import quarantine as TQ
from lightning_tpu_torch.utils import events as TEV
from lightning_tpu_torch.utils import trace as TT

torch.set_num_threads(1)

N = 27
BAD = 5                       # the signature with a flipped byte


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Breakers, armed faults and flight rings are process-global."""
    monkeypatch.delenv("LIGHTNING_TPU_FAULT", raising=False)
    monkeypatch.delenv("LIGHTNING_TPU_DEADLINE_VERIFY_S", raising=False)
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()
    yield
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()


@pytest.fixture(scope="module")
def signed():
    """27 channel_update-sized messages signed by S1/S2's plain versions
    from a numpy seed; one signature's byte flipped."""
    rows, nb, sigs, pubs = synth.make_signed_batch(
        N, np.random.default_rng(11), device="cpu")
    sigs = sigs.copy()
    sigs[BAD, 10] ^= 0x40
    z = np.stack([np.frombuffer(hashlib.sha256(hashlib.sha256(
        rows[i, :130].tobytes()).digest()).digest(), np.uint8)
        for i in range(N)])
    expected = np.ones(N, bool)
    expected[BAD] = False
    assert np.array_equal(S.host_verify_batch(z, sigs, pubs), expected)
    return rows, nb, sigs, pubs, z, expected


def _items(mod, signed):
    rows, nb, sigs, pubs = signed[:4]
    return mod.VerifyItems(rows, nb, sigs, pubs, np.arange(N, dtype=np.int64))


_HOST_VERIFY = S.host_verify_batch   # bound at import: tests forbid it


def _oracle(signed):
    _, _, sigs, pubs, z, _ = signed
    verify = _HOST_VERIFY

    def check(sel):
        return verify(z[sel], sigs[sel], pubs[sel])
    return check


def _port_stub(signed, poison=frozenset(), calls=None):
    check = _oracle(signed)

    def dispatch(b):
        sel = np.asarray(b.sel)
        if calls is not None:
            calls.append(tuple(sel.tolist()))
        if poison & set(sel.tolist()):
            raise ValueError("row rejected by the card")
        return torch.from_numpy(check(sel))
    return dispatch


def _jax_stub(signed, bucket, poison=frozenset()):
    check = _oracle(signed)

    def dispatch(pb):
        sel = pb.sel[:pb.n_real]
        if poison & set(sel.tolist()):
            raise ValueError("row rejected by the card")
        out = np.zeros(bucket, bool)
        out[:len(sel)] = check(sel)
        return out
    return dispatch


def _counter(name: str, **labels) -> float:
    fam = TO.snapshot()["metrics"].get(name, {"samples": []})
    return sum(s.get("value", s.get("count", 0)) for s in fam["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _forbid_host(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("the replay reached the host oracle")
    monkeypatch.setattr(S, "host_verify_batch", forbidden)
    monkeypatch.setattr(TV, "host_verify_items", forbidden)


# ---------------------------------------------------------------------------
# the machinery


def test_depth_0_and_depth_2_give_the_same_verdicts(signed, monkeypatch):
    _forbid_host(monkeypatch)
    items = _items(TV, signed)
    outs = []
    for depth in (0, 2):
        stats: dict = {}
        corr = TT.new_corr()
        outs.append(TV.verify_items(items, 8, device="cpu", stats=stats,
                                    depth=depth, device_fn=_port_stub(signed),
                                    corr=corr))
        assert stats["buckets"] == 4 and stats["prep"] > 0
        assert set(stats) == {"buckets", "prep", "prep_stall", "dispatch",
                              "readback"}
        recs = TFL.recent("verify")[-4:]
        assert [r["outcome"] for r in recs] == ["ok"] * 4
        assert [r["n_real"] for r in recs] == [8, 8, 8, 3]
        assert all(r["corr_ids"] == [corr.corr_id] for r in recs)
    assert np.array_equal(outs[0], signed[5])
    assert np.array_equal(outs[1], signed[5])
    spans = [r for r in TT.records() if r["name"] == "verify/dispatch"]
    assert spans and spans[-1]["corr_id"] == corr.corr_id
    TT.reset()


def _synthetic_items(n_rows: int):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, (n_rows, TV.MAX_BLOCKS * 64),
                        dtype=np.uint16).astype(np.uint8)
    pubs = np.zeros((n_rows, 33), np.uint8)
    pubs[:, 0] = 2
    return TV.VerifyItems(rows, np.full(n_rows, 3, np.uint32),
                          np.zeros((n_rows, 64), np.uint8), pubs,
                          np.arange(n_rows, dtype=np.int64))


def _sleepy(sleep_s: float):
    def dispatch(b):
        if sleep_s:
            time.sleep(sleep_s)
        return torch.ones(len(b.sel), dtype=torch.bool)
    return dispatch


STAGES = ("clntpu_replay_prep_seconds_total",
          "clntpu_replay_prep_stall_seconds_total",
          "clntpu_replay_dispatch_seconds_total")


def _stage_deltas(run):
    before = [_counter(n) for n in STAGES]
    ov0 = _counter("clntpu_replay_overlap_ratio")
    q0 = _counter("clntpu_replay_queue_depth")
    run()
    return ([_counter(n) - b for n, b in zip(STAGES, before)],
            _counter("clntpu_replay_overlap_ratio") - ov0,
            _counter("clntpu_replay_queue_depth") - q0)


def test_overlap_hides_prep_at_depth_2_and_not_at_depth_0():
    """The JAX package's overlap contract (tests/test_zz_replay_pipeline.py)
    at 6,000 rows: prep stall >= 90 % of prep serially, <= 20 % with two
    buckets prepared ahead of a dispatcher that takes 4x the prep."""
    items = _synthetic_items(6000)
    bucket = 256
    n_chunks = len(TV._plan_buckets(np.arange(6000), bucket))
    (prep, stall, _), n_ov, n_q = _stage_deltas(lambda: TV.verify_items(
        items, bucket, device="cpu", depth=0, device_fn=_sleepy(0.0)))
    assert prep > 0 and stall >= 0.9 * prep, (stall, prep)
    assert (n_ov, n_q) == (1, 0)
    sleep = max(4.0 * prep / n_chunks, 0.005)
    last = None
    for _ in range(3):    # thread scheduling: allow a preempted wakeup
        (prep2, stall2, disp2), n_ov, n_q = _stage_deltas(
            lambda: TV.verify_items(items, bucket, device="cpu", depth=2,
                                    device_fn=_sleepy(sleep)))
        assert prep2 > 0 and n_ov == 1 and n_q == n_chunks
        last = (stall2, prep2, disp2)
        if stall2 <= 0.2 * prep2 and stall2 <= 0.2 * (stall2 + disp2):
            break
    else:
        raise AssertionError(f"overlap never hid 80 % of prep: {last}")


@pytest.mark.parametrize("depth", [0, 2])
def test_prep_errors_propagate(depth):
    items = _synthetic_items(64)
    items.pubkeys = items.pubkeys[:10]    # a later bucket's gather fails
    with pytest.raises(IndexError):
        TV.verify_items(items, 8, device="cpu", depth=depth,
                        device_fn=_sleepy(0.0))
    assert all(r["outcome"] for r in TFL.recent("verify"))


def test_a_hung_producer_delays_the_replay_and_skips_no_bucket():
    """A producer that hangs before every bucket: the dispatch thread
    waits for it (the wait is prep stall), and every bucket is
    dispatched once, in order."""
    items = _synthetic_items(64)
    calls: list = []

    def counting(b):
        calls.append(tuple(b.sel.tolist()))
        return torch.ones(len(b.sel), dtype=torch.bool)

    (_, stall, _), _, _ = _stage_deltas(lambda: _replay_hung(items, counting))
    assert calls == [tuple(range(i, i + 8)) for i in range(0, 64, 8)]
    assert stall >= 8 * 0.04, stall


def _replay_hung(items, dispatch):
    with TFI.arm("producer:verify:hang:1:0.05"):
        ok = TV.verify_items(items, 8, device="cpu", depth=2,
                             device_fn=dispatch)
    assert ok.all() and len(ok) == 64


def test_a_transient_device_error_bisects_and_counts_a_failure(signed):
    calls: list = []
    stub = _port_stub(signed, calls=calls)

    def flaky(b):
        if len(calls) == 1:
            calls.append(None)
            raise RuntimeError("the card fell over")
        return stub(b)

    ok = TV.verify_items(_items(TV, signed), 8, device="cpu", depth=2,
                         device_fn=flaky)
    assert np.array_equal(ok, signed[5])
    assert TB.get("verify").consecutive_failures == 0
    assert [r["outcome"] for r in TFL.recent("verify")] == \
        ["ok", "bisect", "ok", "ok"]


# ---------------------------------------------------------------------------
# parity under faults: the test makes the JAX package's host re-check


def _record_host_rows(monkeypatch, mod, rows: list):
    real = mod._host_verify_selected

    def recording(items, roi, idx):
        rows.extend(int(i) for i in np.asarray(idx))
        return real(items, roi, idx)
    monkeypatch.setattr(mod, "_host_verify_selected", recording)


def _transitions(bus, seen: list):
    def tap(p):
        seen.append((p["to"], p["consecutive_failures"]))
    bus.subscribe("breaker_transition", tap)
    return tap


def _outcomes(fl):
    """Each bucket's record, in dispatch order (a raising dispatch is
    sealed at once, the others at the readback)."""
    return [(r["outcome"], r["quarantined"], r["faults"], r.get("error"))
            for r in sorted(fl.recent("verify"),
                            key=lambda r: r["dispatch_id"])]


CASES = [("dispatch:verify:raise:0.5", 8, {13}),
         ("dispatch:verify:raise:1", 4, set()),
         ("readback:verify:raise:0.5", 8, {20}),
         ("dispatch:verify:raise:0.5,readback:verify:raise:0.34", 4, {2, 3})]


@pytest.mark.parametrize("spec,bucket,poison", CASES)
def test_faults_with_host_recheck_match_the_jax_package(
        signed, monkeypatch, spec, bucket, poison):
    """Under the same spec and dispatcher the JAX package re-checks rows
    on the host and returns; the port raises instead.  Dispatch faults:
    the port's ``Quarantined`` carries exactly the rows the JAX package
    re-checked, and with those re-checked here by the exact-int oracle
    the verdicts, flight records and breaker transitions are the JAX
    package's.  Readback faults and an open breaker: the port raises at
    the bucket the JAX package first sent to the host, with the same
    records and transitions up to it."""
    j_rows: list = []
    _record_host_rows(monkeypatch, JV, j_rows)
    t_tr, j_tr = [], []
    taps = [(TEV, _transitions(TEV, t_tr)), (JEV, _transitions(JEV, j_tr))]
    raised = got = None
    try:
        with JFI.arm(spec):
            want = JV.verify_items(_items(JV, signed), bucket=bucket, depth=2,
                                   device_fn=_jax_stub(signed, bucket,
                                                       poison))
        with TFI.arm(spec):
            try:
                got = TV.verify_items(_items(TV, signed), bucket,
                                      device="cpu", depth=2,
                                      device_fn=_port_stub(signed, poison))
            except (TQ.Quarantined, TFI.FaultInjected, TB.BreakerOpen) as e:
                raised = e
    finally:
        for bus, tap in taps:
            bus.unsubscribe("breaker_transition", tap)
    assert np.array_equal(want, signed[5])
    t_out, j_out = _outcomes(TFL), _outcomes(JFL)
    host = {"readback_host": TFI.FaultInjected,
            "host_breaker": TB.BreakerOpen}
    first = next((i for i, r in enumerate(j_out) if r[0] in host), None)
    if first is None:
        assert t_out == j_out and t_tr == j_tr
        if poison:
            assert isinstance(raised, TQ.Quarantined)
            assert raised.rows == sorted(j_rows) == sorted(poison)
            got = raised.verdicts.copy()
            got[raised.rows] = _oracle(signed)(np.asarray(raised.rows))
        else:
            assert raised is None and j_rows == []
        assert np.array_equal(got, want)
    else:
        exc = host[j_out[first][0]]
        assert isinstance(raised, exc)
        assert t_out[:first] == j_out[:first]
        assert (t_out[first][0], t_out[first][3]) == ("error", exc.__name__)
        assert t_tr == j_tr[:len(t_tr)]


# ---------------------------------------------------------------------------
# nothing goes to the host


def test_a_quarantined_row_raises_with_the_rows_the_jax_package_rechecks(
        signed, monkeypatch):
    spec, bucket, poison = CASES[0]
    j_rows: list = []
    _record_host_rows(monkeypatch, JV, j_rows)
    with JFI.arm(spec):
        want = JV.verify_items(_items(JV, signed), bucket=bucket, depth=2,
                               device_fn=_jax_stub(signed, bucket, poison))
    _forbid_host(monkeypatch)
    q0 = _counter("clntpu_quarantine_total", family="verify",
                  reason="ValueError")
    with TFI.arm(spec):
        with pytest.raises(TQ.Quarantined) as e:
            TV.verify_items(_items(TV, signed), bucket, device="cpu",
                            depth=2, device_fn=_port_stub(signed, poison))
    assert e.value.rows == sorted(j_rows) == sorted(poison)
    keep = np.ones(N, bool)
    keep[e.value.rows] = False
    assert np.array_equal(e.value.verdicts[keep], want[keep])
    assert not e.value.verdicts[e.value.rows].any()
    assert _counter("clntpu_quarantine_total", family="verify",
                    reason="ValueError") == q0 + len(poison)
    assert [r["outcome"] for r in TFL.recent("verify")] == \
        ["ok", "bisect", "ok", "bisect"]


def test_an_open_breaker_raises_with_its_retry_time(signed, monkeypatch):
    _forbid_host(monkeypatch)
    TB.get("verify").force_open()
    with pytest.raises(TB.BreakerOpen) as e:
        TV.verify_items(_items(TV, signed), 8, device="cpu", depth=2,
                        device_fn=_port_stub(signed))
    assert e.value.family == "verify" and 0 < e.value.retry_in_s <= 1.1
    assert [r["outcome"] for r in TFL.recent("verify")] == ["error"]


def test_a_readback_failure_raises(signed, monkeypatch):
    _forbid_host(monkeypatch)
    with TFI.arm("readback:verify:raise:1"):
        with pytest.raises(TFI.FaultInjected):
            TV.verify_items(_items(TV, signed), 8, device="cpu", depth=0,
                            device_fn=_port_stub(signed))
    recs = TFL.recent("verify")
    assert [r["outcome"] for r in recs] == ["error", "ok", "ok", "ok"]
    assert TB.get("verify").consecutive_failures == 1


def test_a_lost_card_raises_at_once_without_bisecting(signed, monkeypatch):
    _forbid_host(monkeypatch)
    calls: list = []
    monkeypatch.setattr(TV, "_card_answers", lambda device: False)
    with pytest.raises(TV.CardLost):
        TV.verify_items(_items(TV, signed), 8, device="cpu", depth=2,
                        device_fn=_port_stub(signed, {3}, calls))
    assert calls == [tuple(range(8))]


def test_no_replay_thread_leaks():
    deadline = time.time() + 10
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "replay-prep" and t.is_alive()]
        if not alive:
            return
        time.sleep(0.05)
    raise AssertionError(f"leaked replay-prep threads: {alive}")


# ---------------------------------------------------------------------------
# the real plain kernels (two replays)


def test_plain_kernels_under_faults_give_the_seeded_verdicts(signed,
                                                             monkeypatch):
    _forbid_host(monkeypatch)
    items = _items(TV, signed)
    with TFI.arm("dispatch:verify:raise:1"):
        ok = TV.verify_items(items, 32, device="cpu")
    assert np.array_equal(ok, signed[5])
    assert TFL.recent("verify")[-1]["outcome"] == "bisect"
    with TFI.arm("dispatch:verify:raise:0.5"):
        ok = TV.verify_items(items, 16, device="cpu", depth=2)
    assert np.array_equal(ok, signed[5])
    assert sorted(r["outcome"] for r in TFL.recent("verify")[-2:]) == \
        ["bisect", "ok"]
