"""The port's gossip_store writer and recovery against the JAX package's.

The same records go through both packages' StoreWriter, and the same
torn or corrupted stores through both packages' scan_valid_prefix,
recover_store, mark_deleted and compact_store: the files they leave must
be byte-identical and their StoreRecovery fields equal.  CRC-bad records
are re-checked by one exact-int checker on both sides; one case re-checks
through the port's verify_items on the CPU instead.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from lightning_tpu.gossip import store as JST
from lightning_tpu_torch.crypto import ref_python as ref
from lightning_tpu_torch.gossip import store as TST
from lightning_tpu_torch.gossip import verify as TV
from lightning_tpu_torch.gossip import wire

torch.set_num_threads(1)

K1, K2 = 11111, 22222
SCID = (600000 << 40) | (1 << 16)


def _pub(k: int) -> bytes:
    return ref.pubkey_serialize(ref.pubkey_create(k))


def _sign(m: bytearray, signed_offset: int, slots) -> bytes:
    h = ref.sha256d(bytes(m[signed_offset:]))
    for off, k in slots:
        r, s = ref.ecdsa_sign(h, k)
        m[off:off + 64] = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return bytes(m)


def make_na(k: int, ts: int) -> bytes:
    na = wire.NodeAnnouncement(timestamp=ts, node_id=_pub(k),
                               alias=b"store-test".ljust(32, b"\0"))
    return _sign(bytearray(na.serialize()), wire.NA_SIGNED_OFFSET,
                 [(wire.NA_SIG_OFFSET, k)])


def make_channel(scid: int, ts: int) -> list[bytes]:
    """A channel_announcement of K1-K2 and one update each way."""
    ka, kb = sorted((K1, K2), key=_pub)
    ca = wire.ChannelAnnouncement(
        short_channel_id=scid, node_id_1=_pub(ka), node_id_2=_pub(kb),
        bitcoin_key_1=_pub(ka), bitcoin_key_2=_pub(kb))
    out = [_sign(bytearray(ca.serialize()), wire.CA_SIGNED_OFFSET,
                 zip(wire.CA_SIG_OFFSETS, (ka, kb, ka, kb)))]
    for d, k in ((0, ka), (1, kb)):
        cu = wire.ChannelUpdate(short_channel_id=scid, timestamp=ts,
                                channel_flags=d, htlc_maximum_msat=10 ** 9)
        out.append(_sign(bytearray(cu.serialize()), wire.CU_SIGNED_OFFSET,
                         [(wire.CU_SIG_OFFSET, k)]))
    return out


def fake_msg(i: int, n: int = 40) -> bytes:
    return (257).to_bytes(2, "big") + bytes([i % 256] * n)


def oracle_check(msgs) -> list[bool]:
    """Exact-int re-check of node_announcements (the rows this file
    corrupts); anything else fails."""
    out = []
    for m in msgs:
        try:
            p = wire.parse_gossip(m)
        except Exception:
            out.append(False)
            continue
        if p.TYPE != wire.MSG_NODE_ANNOUNCEMENT:
            out.append(False)
            continue
        h = ref.sha256d(p.signed_region())
        out.append(ref.ecdsa_verify(
            h, int.from_bytes(p.signature[:32], "big"),
            int.from_bytes(p.signature[32:], "big"),
            ref.pubkey_parse(p.node_id)))
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _fields(rep) -> dict:
    d = dataclasses.asdict(rep)
    d.pop("path")
    return d


def _both(tmp: str, name: str, write) -> tuple[str, str]:
    """Run `write(module, path)` for both packages on files of the same
    name in two directories."""
    paths = []
    for mod, sub in ((JST, "jax"), (TST, "port")):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        p = os.path.join(tmp, sub, name)
        write(mod, p)
        paths.append(p)
    return paths[0], paths[1]


def test_writer_bytes_and_flags_match(tmp_path):
    assert (TST.FLAG_DELETED, TST.FLAG_PUSH, TST.FLAG_RATELIMIT,
            TST.FLAG_DYING) == (JST.FLAG_DELETED, JST.FLAG_PUSH,
                                JST.FLAG_RATELIMIT, JST.FLAG_DYING)
    msgs = [fake_msg(i, 20 + i) for i in range(5)]

    def write(mod, p):
        with mod.StoreWriter(p) as w:
            w.append(msgs[0], timestamp=7, flags=mod.FLAG_PUSH, sync=True)
            w.append(msgs[1], flags=mod.FLAG_RATELIMIT | mod.FLAG_DYING)
            w.sync()
            w.append_many(msgs[2:], [100, 101, 102], sync=True)
            w.append_many([msgs[0]])

    a, b = _both(str(tmp_path), "w.gs", write)
    assert _read(a) == _read(b)
    idx = TST.load_store(b)
    assert idx.flags.tolist() == [TST.FLAG_PUSH,
                                  TST.FLAG_RATELIMIT | TST.FLAG_DYING,
                                  0, 0, 0, 0]
    assert idx.check_crcs().all()


def _torn_store(tmp: str, lens: list[int], cut: int) -> tuple[str, str]:
    def write(mod, p):
        with mod.StoreWriter(p) as w:
            w.append_many([fake_msg(i, n) for i, n in enumerate(lens)],
                          list(range(len(lens))))
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(1, size - cut))

    return _both(tmp, "torn.gs", write)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(lens=st.lists(st.integers(0, 300), min_size=1, max_size=8),
       cut=st.integers(0, 400))
def test_torn_tails_recover_identically(lens, cut):
    with tempfile.TemporaryDirectory() as tmp:
        a, b = _torn_store(tmp, lens, cut)
        assert TST.scan_valid_prefix(b) == JST.scan_valid_prefix(a)
        ia, ra = JST.recover_store(a)
        ib, rb = TST.recover_store(b)
        assert _read(a) == _read(b)
        assert _fields(ra) == _fields(rb)
        assert len(ib) == len(ia) == rb.records
        assert TST.scan_valid_prefix(b) == os.path.getsize(b)


def test_bootstrap_and_empty(tmp_path):
    a, b = (str(tmp_path / n) for n in ("a.gs", "b.gs"))
    ia, ra = JST.recover_store(a)
    ib, rb = TST.recover_store(b)
    assert _fields(ra) == _fields(rb) and rb.bootstrapped
    assert _read(a) == _read(b) == bytes([TST.VERSION_BYTE])
    assert len(ib) == 0 and TST.scan_valid_prefix(b) == 1
    empty = str(tmp_path / "empty.gs")
    open(empty, "wb").close()
    assert TST.scan_valid_prefix(empty) == 0


def _crc_bad_store(tmp: str, rows: dict[int, str]) -> tuple[str, str]:
    """Three signed node_announcements; in each row of `rows` either the
    timestamp ("ts": the CRC fails, the signature still holds) or a
    signature byte ("sig": both fail) is corrupted, and a torn half
    record is left at the end."""
    msgs = [make_na(k, 100 + i) for i, k in enumerate((K1, K2, 33333))]

    def write(mod, p):
        with mod.StoreWriter(p) as w:
            w.append_many(msgs, [100, 101, 102], sync=True)
        idx = mod.load_store(p)
        offs = [int(o) for o in idx.offsets]
        del idx
        with open(p, "r+b") as f:
            for i, what in rows.items():
                if what == "ts":
                    f.seek(offs[i] - 4)
                    f.write((999).to_bytes(4, "big"))
                else:
                    f.seek(offs[i] + wire.NA_SIG_OFFSET + 5)
                    f.write(b"\xee")
            f.seek(0, 2)
            f.write(b"\x00\x00\x00\x40\x00\x00")

    return _both(tmp, "crc.gs", write)


@pytest.mark.parametrize("check", ["oracle", "none", "raises"])
def test_crc_bad_rows_recover_identically(tmp_path, check):
    a, b = _crc_bad_store(str(tmp_path), {0: "ts", 2: "sig"})

    def boom(msgs):
        raise RuntimeError("checker failed")

    fn = {"oracle": oracle_check, "none": None, "raises": boom}[check]
    ia, ra = JST.recover_store(a, check_sigs=fn)
    ib, rb = TST.recover_store(b, check_sigs=fn)
    assert _read(a) == _read(b)
    assert _fields(ra) == _fields(rb)
    assert rb.truncated_bytes == 6 and rb.crc_bad == 2
    assert (rb.requalified, rb.dropped_rows) == (
        (1, [2]) if check == "oracle" else (0, [0, 2]))
    assert np.array_equal(ia.flags, ib.flags)
    # check_crc=False trusts every row
    _, rc = TST.recover_store(b, check_crc=False)
    assert rc.crc_bad == 0 and rc.records == 3


def test_crc_bad_row_requalified_by_the_ports_verify(tmp_path):
    """The re-check as the chip smoke does it, through the port's
    verify_items (here on the CPU)."""
    a, b = _crc_bad_store(str(tmp_path), {1: "ts", 2: "sig"})

    def port_check(msgs):
        items = TV.message_items([wire.parse_gossip(m) for m in msgs],
                                 None)
        return TV.verify_items(items, device="cpu").tolist()

    JST.recover_store(a, check_sigs=oracle_check)
    _, rb = TST.recover_store(b, check_sigs=port_check)
    assert _read(a) == _read(b)
    assert (rb.requalified, rb.dropped_rows) == (1, [2])


def test_mark_deleted_and_compact_match(tmp_path):
    scid2 = SCID + (1 << 16)
    msgs = make_channel(SCID, 100) + make_channel(scid2, 200) \
        + [make_na(K1, 5)]

    def write(mod, p):
        with mod.StoreWriter(p) as w:
            w.append_many(msgs, list(range(len(msgs))), sync=True)

    a, b = _both(str(tmp_path), "m.gs", write)
    assert JST.mark_deleted(a, {SCID}) == TST.mark_deleted(b, {SCID}) == 3
    assert _read(a) == _read(b)
    # flagging again finds nothing new
    assert TST.mark_deleted(b, {SCID}) == 0
    ca, cb = a + ".c", b + ".c"
    assert JST.compact_store(a, ca) == TST.compact_store(b, cb) == 4
    assert _read(ca) == _read(cb)
    idx = TST.load_store(cb)
    assert idx.alive().all() and idx.check_crcs().all()
    assert [idx.message(i) for i in range(len(idx))] == msgs[3:]
