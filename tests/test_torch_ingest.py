"""The port's live gossip ingest against the JAX package's.

One message sequence goes through both packages' GossipIngest under one
fake clock, flushed at the same points.  The JAX ingest runs in its own
CPU mode (LIGHTNING_TPU_VERIFY_DEVICE=off: its buckets go to its host
oracle, no EC program compiles); the port's verifies with the plain
versions of K1-K3 (device="cpu").  Both must leave byte-identical stores,
equal IngestStats, equal state tables and equal gossmaps.  The overload
controller and the circuit breaker are held against the JAX package's on
the same inputs.
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from lightning_tpu.gossip import gossmap as JGM
from lightning_tpu.gossip import ingest as JI
from lightning_tpu.gossip import store as JST
from lightning_tpu import obs as JOBS
from lightning_tpu.obs import journey as JJ
from lightning_tpu.resilience import breaker as JB
from lightning_tpu.resilience import overload as JO
from lightning_tpu_torch import convert
from lightning_tpu_torch import obs as TOBS
from lightning_tpu_torch.obs import journey as TJ
from lightning_tpu_torch.crypto import ref_python as ref
from lightning_tpu_torch.gossip import gossmap as TGM
from lightning_tpu_torch.gossip import ingest as TI
from lightning_tpu_torch.gossip import store as TST
from lightning_tpu_torch.gossip import verify as TV
from lightning_tpu_torch.gossip import wire
from lightning_tpu_torch.resilience import breaker as TB
from lightning_tpu_torch.resilience import overload as TO
from lightning_tpu_torch.utils import events as TEV

torch.set_num_threads(1)

K1, K2, K3, K4, K5 = 11111, 22222, 33333, 44444, 55555


def scid(n: int) -> int:
    return (600000 << 40) | (n << 16)


def pub(k: int) -> bytes:
    return ref.pubkey_serialize(ref.pubkey_create(k))


def _sign(m: bytearray, signed_offset: int, slots) -> bytes:
    h = ref.sha256d(bytes(m[signed_offset:]))
    for off, k in slots:
        r, s = ref.ecdsa_sign(h, k)
        m[off:off + 64] = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return bytes(m)


def _ordered(ka, kb):
    return (ka, kb) if pub(ka) < pub(kb) else (kb, ka)


def make_ca(ka: int, kb: int, n: int, tag: bytes | None = None) -> bytes:
    """A channel_announcement; `tag` replaces node 2's key tag after the
    keys are chosen (the signatures stay those of the real keys)."""
    ka, kb = _ordered(ka, kb)
    k2 = pub(kb) if tag is None else tag + pub(kb)[1:]
    ca = wire.ChannelAnnouncement(
        short_channel_id=scid(n), node_id_1=pub(ka), node_id_2=k2,
        bitcoin_key_1=pub(ka), bitcoin_key_2=pub(kb))
    return _sign(bytearray(ca.serialize()), wire.CA_SIGNED_OFFSET,
                 zip(wire.CA_SIG_OFFSETS, (ka, kb, ka, kb)))


def make_cu(ka: int, kb: int, n: int, direction: int, ts: int,
            signer: int | None = None) -> bytes:
    ka, kb = _ordered(ka, kb)
    cu = wire.ChannelUpdate(
        short_channel_id=scid(n), timestamp=ts, channel_flags=direction,
        htlc_maximum_msat=10 ** 9, fee_base_msat=1000 + ts,
        fee_proportional_millionths=10)
    k = signer if signer is not None else (ka if direction == 0 else kb)
    return _sign(bytearray(cu.serialize()), wire.CU_SIGNED_OFFSET,
                 [(wire.CU_SIG_OFFSET, k)])


def make_na(k: int, ts: int, big: bool = False) -> bytes:
    """A node_announcement; `big` pushes its signed region past the
    verifier's 8 SHA blocks (hashed on the host, verified on the card)."""
    na = wire.NodeAnnouncement(
        timestamp=ts, node_id=pub(k), alias=b"ingest-test".ljust(32, b"\0"),
        addresses=b"\x01\x7f\x00\x00\x01\x26\x07" * 86 if big else b"")
    return _sign(bytearray(na.serialize()), wire.NA_SIGNED_OFFSET,
                 [(wire.NA_SIG_OFFSET, k)])


def corrupt(m: bytes, off: int) -> bytes:
    b = bytearray(m)
    b[off] ^= 0xFF
    return bytes(b)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


async def no_utxo_for_5(s: int):
    return None if s == scid(5) else 50_000


def _script():
    """(op, arg) steps: "submit" a message, "flush" once, "tick" the
    clock.  Every message kind of gossmap_manage's rules appears."""
    ca12 = make_ca(K1, K2, 1)
    cu12_0 = make_cu(K1, K2, 1, 0, ts=100)
    cu12_1 = make_cu(K1, K2, 1, 1, ts=100)
    steps = [
        # flush 1: a valid CA, a corrupt CA, a CA with a 0x04 key tag, an
        # oversized NA of a channeled node, an NA of a node with no
        # channel, the valid CA again inside the batch, and two updates
        # that arrive before their channel
        ("submit", ca12),
        ("submit", corrupt(make_ca(K2, K3, 3), 10)),
        ("submit", make_ca(K1, K4, 4, tag=b"\x04")),
        ("submit", make_na(K1, 50, big=True)),
        ("submit", make_na(K3, 60)),
        ("submit", ca12),
        ("submit", cu12_0),
        ("submit", make_cu(K1, K3, 2, 0, ts=70)),
        ("submit", b"\x01\x00\x05"),              # truncated CA
        ("submit", (259).to_bytes(2, "big") + b"\0" * 8),  # unknown type
        ("flush", None),
        # flush 2: updates, one signed by the wrong node, the channel that
        # releases the held update and node, a duplicate after accept,
        # a channel whose funding output the UTXO check rejects
        ("submit", cu12_1),
        ("submit", make_cu(K1, K2, 1, 1, ts=90, signer=K3)),
        ("submit", make_ca(K1, K3, 2)),
        ("submit", ca12),
        ("submit", make_ca(K2, K5, 5)),
        ("flush", None),
        # flush 3 (with the resubmitted update and node): stale updates, a
        # ratelimited burst, a token after the interval, an own node's
        # announcement twice in one batch; then a flush of nothing
        ("submit", make_cu(K1, K2, 1, 0, ts=90)),
        ("submit", cu12_0),
    ] + [("submit", make_cu(K1, K2, 1, 1, ts=101 + i)) for i in range(5)] \
      + [("tick", TI.RATELIMIT_INTERVAL),
         ("submit", make_cu(K1, K2, 1, 1, ts=110)),
         ("submit", make_na(K2, 80)),
         ("submit", make_na(K2, 80)),
         ("flush", None),
         ("flush", None)]
    return steps


async def _drive(mod, path, steps, device_kw):
    clock = Clock()
    streamed = []
    ing = mod.GossipIngest(path, flush_ms=1.0, bucket=64, now=clock,
                           utxo_check=no_utxo_for_5, own_node_id=pub(K2),
                           on_accept=lambda raw, src: streamed.append(raw),
                           **device_kw)
    for op, arg in steps:
        if op == "submit":
            await ing.submit(arg, source="peer")
        elif op == "tick":
            clock.t += arg
        else:
            await ing.flush()
    await ing.close()
    return ing, streamed


def _state(ing) -> dict:
    return {
        "stats": dataclasses.asdict(ing.stats),
        "channels": ing.channels, "updates": ing.updates,
        "nodes": ing.nodes,
        "pending_updates": {s: sorted(d) for s, d in
                            ing.pending_updates.items()},
        "pending_nodes": sorted(ing.pending_nodes),
        "queued": [it.raw for it in ing._queue],
    }


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def jax_cpu_verify(monkeypatch):
    monkeypatch.setenv("LIGHTNING_TPU_VERIFY_DEVICE", "off")
    yield
    JO.reset_for_tests()
    TO.reset_for_tests()
    JB.reset_for_tests()
    TB.reset_for_tests()


@pytest.fixture(scope="module")
def script():
    return _script()


def _journeys(J) -> list:
    """Every journey, keyed and ordered by entity, its hops without the
    process's ids and times: wait_ms stays (the fake clock's), and of the
    dispatch and corr ids only whether the hop has one."""
    out = []
    for j in sorted(J.recent(limit=0), key=lambda j: (j["kind"],
                                                      str(j["key"]))):
        out.append((j["kind"], j["key"], j["done"], j["truncated"], [
            (h["hop"], h["outcome"], h["wait_ms"], h.get("attrs"),
             h["dispatch_id"] is not None, h["corr_id"] is not None)
            for h in j["hops"]]))
    return out


def _batch_wait(o) -> float:
    fam = o.snapshot()["metrics"]["clntpu_journey_batch_wait_seconds_total"]
    return sum(x["value"] for x in fam["samples"]
               if x["labels"]["stage"] == "verify")


def test_ingest_matches_jax_package(tmp_path, jax_cpu_verify, script,
                                    monkeypatch):
    """With every entity's journey sampled: the stores, stats, tables,
    streams and gossmaps, and the journeys' hops (admit, verify, store,
    the drops and sheds) and the batch-side queue wait."""
    monkeypatch.setenv("LIGHTNING_TPU_JOURNEY_SAMPLE", "1")
    JJ.reset_for_tests()
    TJ.configure(sample=1)
    w0 = (_batch_wait(JOBS), _batch_wait(TOBS))
    jp, tp = str(tmp_path / "jax.gs"), str(tmp_path / "port.gs")
    try:
        jing, jstream = asyncio.run(_drive(JI, jp, script, {}))
        ting, tstream = asyncio.run(_drive(TI, tp, script,
                                           {"device": "cpu"}))
        jour = _journeys(JJ), _journeys(TJ)
    finally:
        monkeypatch.delenv("LIGHTNING_TPU_JOURNEY_SAMPLE")
        JJ.reset_for_tests()
        TJ.reset_for_tests()
    assert jour[1] == jour[0] and len(jour[1]) >= 8
    hops = {h[0] for j in jour[1] for h in j[4]}
    assert {"admit", "verify", "store", "drop"} <= hops
    assert _batch_wait(TOBS) - w0[1] == _batch_wait(JOBS) - w0[0]
    assert _read(tp) == _read(jp)
    assert _state(ting) == _state(jing)
    assert tstream == jstream
    st = ting.stats
    assert st.flushes == 3 and st.accepted == 11
    assert st.dropped == {
        TI.R_BADSIG: 3, TI.R_DUP: 2, TI.R_NO_CHANNEL: 3,
        TI.R_MALFORMED: 2, TI.R_NO_UTXO: 1, TI.R_STALE: 3,
        TI.R_RATELIMIT: 3}
    # the gossmap of the written store, and the JAX map carried over
    jidx, tidx = JST.load_store(jp), TST.load_store(tp)
    jg, tg = JGM.from_store(jidx), TGM.from_store(tidx)
    assert tg.listchannels() == jg.listchannels()
    assert tg.listnodes() == jg.listnodes()
    assert (tg.n_channels, tg.n_nodes) == (2, 3)
    assert _gossmap_equal(convert.gossmap(jg), tg)
    for g in (jg, tg):
        assert g.apply_channel_update(
            scid(2), 1, timestamp=500, disabled=True, cltv_delta=40,
            htlc_min_msat=1, htlc_max_msat=10 ** 8, fee_base_msat=7,
            fee_ppm=9)
        assert not g.apply_channel_update(
            scid(9), 0, timestamp=500, disabled=False, cltv_delta=40,
            htlc_min_msat=1, htlc_max_msat=10 ** 8, fee_base_msat=7,
            fee_ppm=9)
        g.ensure_adjacency()
    assert _gossmap_equal(convert.gossmap(jg), tg)
    assert tg.param_entries_since(0) == jg.param_entries_since(0) == [(1, 1)]
    assert tg.listchannels() == jg.listchannels()


def _gossmap_equal(a, b) -> bool:
    for f in dataclasses.fields(TGM.Gossmap):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def test_ingest_loop_matches_jax_package(tmp_path, jax_cpu_verify):
    """The supervised loop: start, submit without yielding, drain, close
    (a channel, its two updates held until it lands, a node)."""
    msgs = [make_ca(K1, K2, 1), make_cu(K1, K2, 1, 0, ts=100),
            make_cu(K1, K2, 1, 1, ts=100), make_na(K1, ts=100)]

    async def run(mod, path, **kw):
        ing = mod.GossipIngest(path, flush_ms=1.0, bucket=64, **kw)
        ing.start()
        for m in msgs:
            await ing.wait_capacity()
            await ing.submit(m)
        await ing.drain()
        await ing.close()
        return ing

    jp, tp = str(tmp_path / "jax.gs"), str(tmp_path / "port.gs")
    jing = asyncio.run(run(JI, jp))
    ting = asyncio.run(run(TI, tp, device="cpu"))
    assert _read(tp) == _read(jp)
    assert _state(ting) == _state(jing)
    assert ting.stats.accepted == 4 and ting.stats.flushes == 2


@pytest.mark.parametrize("fault", ["raise", "deadline"])
def test_flush_error_goes_to_the_restart_loop(tmp_path, monkeypatch,
                                              fault):
    """A failing verify is counted as flush_error and emitted on the
    events bus; the loop restarts; nothing is accepted or verified
    elsewhere."""
    def failing(items, bucket, device=None, **kw):
        if fault == "raise":
            raise RuntimeError("device lost")
        import time
        time.sleep(0.3)
        return np.ones(len(items), bool)

    monkeypatch.setattr(TV, "verify_items", failing)
    seen = []
    TEV.subscribe_all(lambda topic, p: seen.append(topic))

    async def run():
        ing = TI.GossipIngest(str(tmp_path / "e.gs"), flush_ms=1.0,
                              device="cpu", deadline_s=0.05)
        ing.start()
        await ing.submit(make_na(K1, 5))
        while ing.stats.dropped.get(TI.R_FLUSH_ERROR, 0) == 0:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)
        assert not ing._task.done()
        await ing.close()
        return ing

    try:
        ing = asyncio.run(run())
    finally:
        TEV.reset()
        TO.reset_for_tests()
    assert ing.stats.dropped == {TI.R_FLUSH_ERROR: 1}
    assert ing.stats.accepted == 0 and ing.stats.flushes == 1
    assert "ingest_flush_error" in seen and "loop_restart" in seen
    assert ("deadline_exceeded" in seen) == (fault == "deadline")
    assert len(TST.load_store(str(tmp_path / "e.gs"))) == 0


def test_shed_at_a_small_watermark_matches_jax_package(tmp_path,
                                                       jax_cpu_verify):
    """A storm submitted without a flush: priority limits, the pending
    cap and the shed ring, against the JAX package's."""
    msgs = [make_ca(K1, K2, 1), make_ca(K2, K3, 2),
            make_na(K3, 5),                       # bulk: sheds at 8
            make_na(K1, 5),                       # own node: admitted
            make_ca(K3, K4, 3)]                   # fresh: 13 > 10, sheds
    msgs += [make_cu(K1, K2, 10 + i, 0, ts=5) for i in range(3)]

    async def run(mod, path, **kw):
        ing = mod.GossipIngest(path, high_wm=8, low_wm=4, pending_cap=2,
                               own_node_id=pub(K1), now=Clock(), **kw)
        for m in msgs:
            await ing.submit(m)
        snap = ing.overload.snapshot()
        await ing.close()
        return ing, snap

    jing, jsnap = asyncio.run(run(JI, str(tmp_path / "j.gs")))
    jsheds = JO.recent_sheds()
    ting, tsnap = asyncio.run(run(TI, str(tmp_path / "t.gs"),
                                  device="cpu"))
    assert TO.recent_sheds() == jsheds and len(jsheds) == 3
    assert _state(ting) == _state(jing)
    assert tsnap == jsnap
    assert tsnap["state"] == "saturated" and tsnap["backlog"] == 9
    assert ting.stats.dropped == {TI.R_SHED: 3, TI.R_NO_CHANNEL: 2}


def test_overload_and_breaker_match_jax_package(jax_cpu_verify):
    clock = Clock()
    j = JO.controller("t", 100, 0, breaker_family="t", now=clock)
    t = TO.controller("t", 100, 0, breaker_family="t", now=clock)
    for pending, inflight in [(0, 0), (30, 10), (50, 0), (80, 30),
                              (120, 0), (60, 0), (49, 0), (10, 140)]:
        got = []
        for c in (j, t):
            c.update(pending, inflight)
            c.note_drain(pending + 1, 0.01 * (inflight + 1))
            got.append((c.state, c.widen_factor(), c.flush_target(256),
                        c.window_s(2.0), c.retry_after_s(),
                        [c.admit(p, n) for p in range(4)
                         for n in (1, 4, 30)],
                        c._drained.is_set()))
        assert got[0] == got[1]
    JB.get("t").force_open()
    TB.get("t").force_open()
    assert t.retry_after_s() == j.retry_after_s()
    assert t.snapshot() == j.snapshot()
    assert t.hard_cap == j.hard_cap == 150
    assert TO.FLUSH_WIDEN == JO.FLUSH_WIDEN and \
        TO.BACKPRESSURE_MAX_S == JO.BACKPRESSURE_MAX_S
    assert (TI.INGEST_HIGH_WM, TI.INGEST_LOW_WM, TI.PENDING_CAP) == (
        JI.INGEST_HIGH_WM, JI.INGEST_LOW_WM, JI.PENDING_CAP)

    # the breaker's state machine on one fake clock
    bj = JB.CircuitBreaker("v", threshold=2, base_backoff=1.0,
                           max_backoff=4.0, disabled=False, clock=clock)
    bt = TB.CircuitBreaker("v", threshold=2, base_backoff=1.0,
                           max_backoff=4.0, clock=clock)
    trace = []
    for step in ["f", "a", "f", "a", "t2", "a", "a", "f", "t1", "a",
                 "t5", "a", "s", "a", "f"]:
        row = []
        for b in (bj, bt):
            if step == "f":
                b.record_failure()
                row.append(None)
            elif step == "s":
                b.record_success()
                row.append(None)
            elif step == "a":
                row.append(b.allow())
            row.append(b.snapshot())
        if step.startswith("t"):
            clock.t += float(step[1:])
        trace.append(row)
        assert row[:len(row) // 2] == row[len(row) // 2:], step
    assert bt.trips == bj.trips == 2
