"""The port's supervision primitives against the JAX package's.

Fault specs fire on the same calls, bisection isolates the same rows,
breakers make the same transitions and count the same metrics, and the
resilience snapshot has the same keys.  The supervised hsmd dispatches
and the store's fault seam and recovery count are held here too: a
failed or refused dispatch raises (the port's rule), and nothing is
signed or checked on the host in its place."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from lightning_tpu import obs as JO
from lightning_tpu.gossip import store as JST
from lightning_tpu.obs import flight as JFL
from lightning_tpu.resilience import breaker as JB
from lightning_tpu.resilience import deadline as JD
from lightning_tpu.resilience import faultinject as JFI
from lightning_tpu.resilience import overload as JOV
from lightning_tpu.resilience import quarantine as JQ
from lightning_tpu.resilience import resilience_snapshot as j_snapshot
from lightning_tpu.utils import events as JEV

from lightning_tpu_torch import obs as TO
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import secp256k1 as S
from lightning_tpu_torch.daemon import hsmd as TH
from lightning_tpu_torch.gossip import store as TST
from lightning_tpu_torch.obs import flight as TFL
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import deadline as TD
from lightning_tpu_torch.resilience import faultinject as TFI
from lightning_tpu_torch.resilience import overload as TOV
from lightning_tpu_torch.resilience import quarantine as TQ
from lightning_tpu_torch.resilience import resilience_snapshot as t_snapshot
from lightning_tpu_torch.utils import events as TEV

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Breakers, armed faults and flight rings are process-global."""
    monkeypatch.delenv("LIGHTNING_TPU_FAULT", raising=False)
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()
    yield
    for m in (TB, TFI, TFL, JB, JFI, JFL):
        m.reset_for_tests()


def _samples(obs_mod, name: str, **labels) -> float:
    fam = obs_mod.snapshot()["metrics"].get(name, {"samples": []})
    return sum(s["value"] for s in fam["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


SPECS = ["dispatch:verify:raise:0.5", "sign:sign:raise:0.1",
         "producer:verify:hang:0.37:0", "*:verify:raise:0.25",
         "prep:*:hang:1:0,readback:verify:raise:0.3",
         "append:store:raise:0.731"]
CALLS = [("dispatch", "verify"), ("sign", "sign"), ("producer", "verify"),
         ("prep", "route"), ("readback", "verify"), ("append", "store"),
         ("mesh", "mesh")]


def _fire_outcomes(fi, spec: str) -> tuple:
    rng = np.random.default_rng(4)
    out = []
    with fi.arm(spec) as specs:
        for _ in range(1000):
            seam, family = CALLS[int(rng.integers(len(CALLS)))]
            try:
                fi.fire(seam, family)
                out.append((seam, family, 0))
            except fi.FaultInjected:
                out.append((seam, family, 1))
        counts = [(s.calls, s.fired) for s in specs]
        armed = fi.active_specs()
    assert fi.active_specs() == []
    return out, counts, armed


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_fire_on_the_same_calls(spec):
    got, want = _fire_outcomes(TFI, spec), _fire_outcomes(JFI, spec)
    assert got == want
    assert any(fired for *_, fired in got[0]) or "hang" in spec \
        or spec.startswith("sign") or spec.startswith("append")
    assert sum(f for _, f in got[1]) > 0


def test_fault_grammar_and_crash_armed_match():
    for s in ("dispatch:verify:raise:0.1,producer:*:hang:1:30",
              "append:store:crash:1", "a:b:crash:1:3"):
        got = [(x.seam, x.family, x.action, x.rate, x.arg, x.raw)
               for x in TFI.parse(s)]
        assert got == [(x.seam, x.family, x.action, x.rate, x.arg, x.raw)
                       for x in JFI.parse(s)]
    for bad in ("dispatch:verify", "a:b:frobnicate:1", "a:b:raise:0",
                "a:b:raise:1.5", "a:b:c:d:e:f"):
        with pytest.raises(ValueError):
            TFI.parse(bad)
        with pytest.raises(ValueError):
            JFI.parse(bad)
    for fi in (TFI, JFI):
        assert not fi.crash_armed("append", "store")
        with fi.arm("append:*:crash:1,dispatch:verify:raise:1"):
            assert fi.crash_armed("append", "store")
            assert not fi.crash_armed("dispatch", "verify")
            assert fi.crash_armed("append", "db")


def test_fault_metered_and_stamped_on_the_flight_record():
    before = _samples(TO, "clntpu_fault_injected_total", seam="readback",
                      family="verify", action="raise")
    with TFI.arm("readback:verify:raise:1"):
        with pytest.raises(TFI.FaultInjected):
            with TFL.dispatch("verify") as rec:
                TFI.fire("readback", "verify")
    assert rec["faults"] == ["readback:verify"] and rec["outcome"] == "error"
    assert _samples(TO, "clntpu_fault_injected_total", seam="readback",
                    family="verify", action="raise") == before + 1


@pytest.mark.parametrize("poison", [set(), {3}, {3, 10}, set(range(16)),
                                    {0, 15, 7}])
def test_bisect_isolates_the_same_rows(poison):
    def run(q, o):
        calls = []

        def attempt(idx):
            calls.append(tuple(int(i) for i in idx))
            if poison & set(int(i) for i in idx):
                raise ValueError("poisoned subset")
            return np.asarray(idx) * 2

        before = _samples(o, "clntpu_quarantine_total", family="qtest",
                          reason="ValueError")
        parts, bad = q.bisect(np.arange(16), attempt, family="qtest")
        n = _samples(o, "clntpu_quarantine_total", family="qtest",
                     reason="ValueError") - before
        return ([(p.tolist(), r.tolist()) for p, r in parts], bad, calls, n)

    got, want = run(TQ, TO), run(JQ, JO)
    assert got == want
    assert got[1] == sorted(poison) and got[3] == len(poison)


def test_bisect_propagates_a_fatal_error_at_once():
    calls = []

    class Lost(RuntimeError):
        pass

    def attempt(idx):
        calls.append(len(idx))
        raise Lost("context lost")

    with pytest.raises(Lost):
        TQ.bisect(np.arange(16), attempt, family="qtest", fatal=(Lost,))
    assert calls == [16]


def _breaker_run(bm, ev, o):
    t = [0.0]
    seen = []

    def tap(p):
        seen.append((p["to"], p["seq"], p["consecutive_failures"],
                     p["backoff_s"]))

    ev.subscribe("breaker_transition", tap)
    fam = "parity-brk"
    try:
        brk = bm.CircuitBreaker(fam, threshold=3, base_backoff=1.0,
                                max_backoff=8.0, clock=lambda: t[0])
        steps = []
        for op in "ffaffafs" + "Tafa" + "T" * 3 + "as" + "ffff" + "Ta" \
                  + "sfsffs":
            if op == "f":
                brk.record_failure()
            elif op == "s":
                brk.record_success()
            elif op == "T":
                t[0] += 1.5 * (2 ** min(brk.trips, 4))
            else:
                steps.append(brk.allow())
            snap = brk.snapshot()
            steps.append((snap["state"], snap["consecutive_failures"],
                          snap["trips"], snap.get("retry_in_s")))
    finally:
        ev.unsubscribe("breaker_transition", tap)
    metrics = {n: sorted(
        (tuple(sorted(s["labels"].items())), s["value"])
        for s in o.snapshot()["metrics"][n]["samples"]
        if s["labels"].get("family") == fam)
        for n in ("clntpu_breaker_state", "clntpu_breaker_transitions_total",
                  "clntpu_breaker_failures_total",
                  "clntpu_breaker_short_circuits_total")}
    return steps, seen, metrics


def test_breaker_transitions_and_metrics_match():
    got = _breaker_run(TB, TEV, TO)
    want = _breaker_run(JB, JEV, JO)
    assert got == want
    assert {s[0] for s in got[1]} == {"open", "half_open", "closed"}


def test_resilience_snapshot_has_the_same_keys():
    t, j = t_snapshot(), j_snapshot()
    assert t.keys() == j.keys() and t["breakers"].keys() == \
        j["breakers"].keys()
    assert t == j
    TB.get("sign").force_open()
    JB.get("sign").force_open()
    with TFI.arm("dispatch:verify:raise:1"), JFI.arm(
            "dispatch:verify:raise:1"):
        t, j = t_snapshot(), j_snapshot()
    assert t.keys() == j.keys()
    for fam in t["breakers"]:
        assert t["breakers"][fam].keys() == j["breakers"][fam].keys()
    assert t["faults_armed"] == j["faults_armed"]
    assert set(TB.all_breakers()) == set(JB.all_breakers())


def test_deadline_and_overload_count_as_the_jax_package_does():
    def run(d, ov, o):
        before = _samples(o, "clntpu_deadline_exceeded_total",
                          family="verify", seam="producer")
        d.note_exceeded("verify", "producer", 0.25)
        n = _samples(o, "clntpu_deadline_exceeded_total", family="verify",
                     seam="producer") - before
        b0 = {k: _samples(o, k, family="ovtest") for k in (
            "clntpu_shed_total", "clntpu_overload_transitions_total")}
        ctl = ov.OverloadController("ovtest", 8, 4, now=lambda: 0.0)
        for pend, inf in ((2, 0), (5, 0), (9, 0), (6, 1), (3, 0), (8, 2)):
            ctl.update(pend, inf)
            for prio in (ov.PRIO_OWN, ov.PRIO_FRESH, ov.PRIO_BULK):
                if not ctl.admit(prio, 2):
                    ctl.shed(prio, "queue_full", kind="test")
        deltas = {k: _samples(o, k, family="ovtest") - v
                  for k, v in b0.items()}
        return n, deltas, _samples(o, "clntpu_overload_state",
                                   family="ovtest"), ctl.snapshot()

    got, want = run(TD, TOV, TO), run(JD, JOV, JO)
    assert got == want and got[0] == 1


# ---------------------------------------------------------------------------
# hsmd's supervised dispatches


def _hsm():
    hsm = TH.Hsm(b"\x07" * 32, device="cpu")
    client = hsm.client(TH.CAP_MASTER, peer_id=b"\x02" * 33, dbid=1)
    return hsm, client, hsm.per_commitment_point(client, 0)


SIGHASHES = [bytes([i]) * 32 for i in range(1, 6)]


def _forbid_host_sign(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("hsmd signed on the host")
    monkeypatch.setattr(E, "host_sign_grind_batch", forbidden)


def test_sign_fault_raises_and_nothing_is_signed_on_the_host(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("the device signer ran after the fault")

    monkeypatch.setattr(E, "ecdsa_sign_batch", forbidden)
    _forbid_host_sign(monkeypatch)
    hsm, client, point = _hsm()
    calls0 = _samples(TO, "clntpu_sign_total", op="htlc")
    for n in (1, 2):
        with TFI.arm("sign:sign:raise:1"):
            with pytest.raises(TFI.FaultInjected):
                hsm.sign_htlc_batch(client, SIGHASHES, point)
        rec = TFL.recent("sign")[-1]
        assert (rec["outcome"], rec["error"]) == ("error", "FaultInjected")
        assert TB.get("sign").consecutive_failures == n
    assert _samples(TO, "clntpu_sign_total", op="htlc") == calls0


def test_sign_breaker_open_raises_with_its_retry_time(monkeypatch):
    monkeypatch.setattr(E, "ecdsa_sign_batch", lambda *a, **kw: 1 / 0)
    _forbid_host_sign(monkeypatch)
    hsm, client, point = _hsm()
    TB.get("sign").force_open()
    with pytest.raises(TB.BreakerOpen) as e:
        hsm.sign_htlc_batch(client, SIGHASHES, point)
    assert e.value.family == "sign" and 0 < e.value.retry_in_s <= 1.1
    rec = TFL.recent("sign")[-1]
    assert (rec["outcome"], rec["error"]) == ("error", "BreakerOpen")


def test_sign_on_the_device_path_counts_and_records(monkeypatch):
    calls = []

    def fake_sign(hashes, keys, device=None):
        calls.append(device)
        return E.host_sign_grind_batch(hashes, keys)

    monkeypatch.setattr(E, "ecdsa_sign_batch", fake_sign)
    hsm, client, point = _hsm()
    dev0 = _samples(TO, "clntpu_sign_total", op="htlc", path="device")
    h2d0 = _samples(TO, "clntpu_transfer_bytes_total", family="sign",
                    direction="h2d")
    hsm.sign_htlc_batch(client, SIGHASHES, point)
    assert calls == [torch.device("cpu")]
    rec = TFL.recent("sign")[-1]
    assert (rec["outcome"], rec["h2d_bytes"], rec["d2h_bytes"]) == \
        ("ok", 5 * 64, 5 * 64)
    assert _samples(TO, "clntpu_sign_total", op="htlc",
                    path="device") == dev0 + 1
    assert _samples(TO, "clntpu_transfer_bytes_total", family="sign",
                    direction="h2d") == h2d0 + 320


def test_check_sigs_shares_the_verify_breaker(monkeypatch):
    hsm, client, point = _hsm()
    priv = hsm.htlc_privkey(client, point)
    hashes = np.frombuffer(b"".join(SIGHASHES), np.uint8).reshape(-1, 32)
    sigs = E.host_sign_grind_batch(hashes, [priv] * 5)
    sigs[2, 40] ^= 1
    from lightning_tpu_torch.crypto import ref_python as ref

    pubs = np.frombuffer(ref.pubkey_serialize(ref.pubkey_create(priv)) * 5,
                         np.uint8).reshape(5, 33)
    want = S.host_verify_batch(hashes, sigs, pubs)
    assert want.tolist() == [True, True, False, True, True]

    def forbidden(*a, **kw):
        raise AssertionError("hsmd checked on the host")
    monkeypatch.setattr(S, "host_verify_batch", forbidden)
    monkeypatch.setattr(E, "ecdsa_verify_batch",
                        lambda h, s, p, bucket, device: want.copy())
    assert np.array_equal(hsm.check_sigs_batch(hashes, sigs, pubs), want)
    assert TFL.recent("check")[-1]["outcome"] == "ok"
    with TFI.arm("dispatch:verify:raise:1"):
        with pytest.raises(TFI.FaultInjected):
            hsm.check_sigs_batch(hashes, sigs, pubs)
    assert TB.get("verify").consecutive_failures == 1
    TB.get("verify").force_open()
    with pytest.raises(TB.BreakerOpen) as e:
        hsm.check_sigs_batch(hashes, sigs, pubs)
    assert e.value.family == "verify"
    assert TFL.recent("check")[-1]["outcome"] == "error"


# ---------------------------------------------------------------------------
# the store's fault seam and recovery count


class _Killed(Exception):
    pass


def test_store_append_crash_seam_tears_mid_record_as_the_jax_package(
        tmp_path, monkeypatch):
    def fake_exit(code):
        raise _Killed(code)

    monkeypatch.setattr(os, "_exit", fake_exit)
    out = {}
    for name, st, fi in (("port", TST, TFI), ("jax", JST, JFI)):
        path = str(tmp_path / f"{name}.gs")
        w = st.StoreWriter(path)
        w.append(b"\x01\x00first record", timestamp=5)
        with fi.arm("append:store:crash:1:9"):
            with pytest.raises(_Killed) as e:
                w.append(b"\x01\x00second record", timestamp=6)
        assert e.value.args == (9,)
        with fi.arm("append:store:raise:1"):
            with pytest.raises(fi.FaultInjected):
                w.append_many([b"\x01\x00third"], [7])
        w.close()
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["jax"]
    assert b"second" not in out["port"] and b"third" not in out["port"]


def test_recover_store_counts_crc_mismatches_as_the_jax_package(tmp_path):
    def damaged(path):
        w = TST.StoreWriter(path)
        w.append_many([b"\x01\x00rec%d" % i for i in range(6)],
                      list(range(100, 106)))
        w.close()
        idx = TST.load_store(path)
        with open(path, "r+b") as f:
            for i in (1, 4):
                f.seek(int(idx.offsets[i]) - 4)
                f.write((999).to_bytes(4, "big"))
            f.seek(0, 2)
            f.write(b"\x00\x00\x00\x20torn")

    got = {}
    for name, st, o in (("port", TST, TO), ("jax", JST, JO)):
        path = str(tmp_path / f"{name}.gs")
        damaged(path)
        keys = (("clntpu_quarantine_total", {"family": "store",
                                             "reason": "crc_mismatch"}),
                ("clntpu_recovery_store_rows_total", {"action": "dropped"}),
                ("clntpu_recovery_store_rows_total",
                 {"action": "requalified"}),
                ("clntpu_recovery_store_truncated_bytes_total", {}))
        before = [_samples(o, n, **lb) for n, lb in keys]
        _, rep = st.recover_store(path, check_sigs=lambda ms: [
            m.endswith(b"4") for m in ms])
        got[name] = ([_samples(o, n, **lb) - b
                      for (n, lb), b in zip(keys, before)],
                     rep.crc_bad, rep.requalified, rep.dropped)
    assert got["port"] == got["jax"]
    assert got["port"][0][:3] == [2, 1, 1]
