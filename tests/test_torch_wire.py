"""The port's wire codec and BOLT messages against the JAX package's.

Both registries hold the same types under the same names and field specs;
seeded messages of every type serialize byte-identically in both packages
and parse back equal, across packages too; the bigsize, TLV and truncated-
integer edge cases of tests/test_wire.py hold on the port.
"""
from __future__ import annotations

import random

import pytest

from lightning_tpu.wire import codec as JC
from lightning_tpu.wire import messages as JM
from lightning_tpu_torch.wire import codec as TC
from lightning_tpu_torch.wire import messages as TM


def _registry(codec, module) -> dict:
    """The types `module` declares (tests may register types of their
    own in the same process)."""
    return {t: cls for t, cls in codec.MessageMeta.registry.items()
            if cls.__module__ == module.__name__}


PORT = _registry(TC, TM)
TYPES = sorted(PORT)


def test_registry_matches_the_jax_package():
    jax = _registry(JC, JM)
    assert {t: c.__name__ for t, c in PORT.items()} == \
        {t: c.__name__ for t, c in jax.items()}
    assert len(PORT) == 44
    for t, cls in PORT.items():
        assert [(f.name, f.kind) for f in cls.FIELDS] == \
            [(f.name, f.kind) for f in jax[t].FIELDS]


_INT_BITS = {"u8": 8, "u16": 16, "u32": 32, "u64": 64, "tu16": 16,
             "tu32": 32, "tu64": 64, "short_channel_id": 64}


def _value(rng: random.Random, kind: str):
    if kind in _INT_BITS:
        bits = _INT_BITS[kind]
        return rng.choice((0, 1, (1 << bits) - 1, rng.getrandbits(bits),
                           rng.getrandbits(rng.randint(1, bits))))
    if kind == "s64":
        return rng.randint(-(1 << 63), (1 << 63) - 1)
    if kind == "bigsize":
        return rng.choice((0, 0xFC, 0xFD, 0xFFFF, 0x10000, 0xFFFFFFFF,
                           0x100000000, rng.getrandbits(64)))
    if kind == "varbytes":
        return rng.randbytes(rng.choice((0, 1, 33, 300)))
    if kind == "remainder":
        return rng.randbytes(rng.randint(0, 90))
    if kind == "tlvs":
        types = sorted(rng.sample(range(0, 70000), rng.randint(0, 4)))
        return {t: rng.randbytes(rng.choice((0, 1, 8, 300))) for t in types}
    if kind.startswith("array:"):
        _, _, elem = kind.split(":", 2)
        return [_value(rng, elem) for _ in range(rng.randint(0, 4))]
    return rng.randbytes(TC.FieldSpec("x", kind).fixed_bytes)


@pytest.mark.parametrize("t", TYPES,
                         ids=[PORT[t].__name__ for t in TYPES])
def test_seeded_messages_match_the_jax_package(t):
    tcls, jcls = TC.MessageMeta.registry[t], JC.MessageMeta.registry[t]
    rng = random.Random(t)
    for _ in range(8):
        vals = {f.name: _value(rng, f.kind) for f in tcls.FIELDS}
        tm, jm = tcls(**vals), jcls(**vals)
        raw = tm.serialize()
        assert raw == jm.serialize()
        assert tcls.parse(raw) == tm
        assert jcls.parse(raw) == jm
        assert TC.parse_message(raw) == tm
        assert TC.msg_type(raw) == t
    assert tcls().serialize() == jcls().serialize()   # every default


BIGSIZE = [
    (0, b"\x00"), (252, b"\xfc"), (253, b"\xfd\x00\xfd"),
    (65535, b"\xfd\xff\xff"), (65536, b"\xfe\x00\x01\x00\x00"),
    (4294967295, b"\xfe\xff\xff\xff\xff"),
    (4294967296, b"\xff\x00\x00\x00\x01\x00\x00\x00\x00"),
]


@pytest.mark.parametrize("val,enc", BIGSIZE)
def test_bigsize_roundtrip(val, enc):
    assert TC.write_bigsize(val) == enc == JC.write_bigsize(val)
    assert TC.read_bigsize(enc, 0) == (val, len(enc))


@pytest.mark.parametrize("bad", [b"\xfd\x00\xfc", b"\xfe\x00\x00\xff\xff",
                                 b"\xff\x00\x00\x00\x00\xff\xff\xff\xff",
                                 b"\xfd\x01", b""])
def test_bigsize_non_minimal_or_truncated_rejected(bad):
    with pytest.raises(TC.WireError):
        TC.read_bigsize(bad, 0)


def test_tlv_roundtrip_and_ordering():
    tlvs = {1: b"\xaa", 3: b"", 0xFFFF: b"hello"}
    enc = TC.write_tlv_stream(tlvs)
    assert enc == JC.write_tlv_stream(tlvs)
    assert TC.read_tlv_stream(enc) == tlvs
    for bad in (TC.write_bigsize(3) + b"\x00" + TC.write_bigsize(1) + b"\x00",
                TC.write_bigsize(3) + b"\x00" + TC.write_bigsize(3) + b"\x00",
                b"\x01\x05abc"):
        with pytest.raises(TC.WireError):
            TC.read_tlv_stream(bad)


def test_messages_roundtrip_and_reject_bad_input():
    m = TM.Init(features=b"\x80\x82", tlvs={1: b"\x01\x02"})
    assert TM.Init.parse(m.serialize()) == m == TC.parse_message(
        m.serialize())
    sigs = [bytes([i]) * 64 for i in range(3)]
    cs = TM.CommitmentSigned(channel_id=b"\x07" * 32, signature=b"\x01" * 64,
                             htlc_signatures=sigs)
    assert TM.CommitmentSigned.parse(cs.serialize()).htlc_signatures == sigs
    p = TM.Ping(num_pong_bytes=4, ignored=b"\x00" * 8)
    assert TC.msg_type(p.serialize()) == 18
    with pytest.raises(TC.WireError):
        TC.parse_message(b"\x99\x99payload")
    with pytest.raises(TC.WireError):
        TC.parse_message(b"\x00")
    raa = TM.RevokeAndAck(channel_id=b"\x01" * 32).serialize()
    with pytest.raises(TC.WireError):
        TM.RevokeAndAck.parse(raa[:-5])
    with pytest.raises(TC.WireError, match="wrong type"):
        TM.Pong.parse(p.serialize())
    with pytest.raises(TC.WireError, match="need 32 bytes"):
        TM.Stfu(channel_id=b"\x00").serialize()
    with pytest.raises(TypeError, match="unknown fields"):
        TM.Stfu(nonsense=1)


def test_truncated_int_kinds():
    class TuMsg(TC.Message):
        TYPE = 64999
        FIELDS = [("flags", "u8"), ("amount", "tu64")]

    class TuMsg32(TC.Message):
        TYPE = 64998
        FIELDS = [("val", "tu32")]

    try:
        for v in (0, 1, 0xFF, 0x100, 0xFFFF_FFFF, 0xFFFF_FFFF_FFFF_FFFF):
            got = TuMsg.parse(TuMsg(flags=7, amount=v).serialize())
            assert got.amount == v and got.flags == 7
        assert TuMsg32(val=0).serialize() == (64998).to_bytes(2, "big")
        assert TuMsg32(val=0x1234).serialize().endswith(b"\x12\x34")
        with pytest.raises(TC.WireError):   # a leading zero
            TuMsg32.parse((64998).to_bytes(2, "big") + b"\x00\x12")
        with pytest.raises(TC.WireError):   # too long for tu32
            TuMsg32.parse((64998).to_bytes(2, "big") + b"\x01\x02\x03\x04\x05")
    finally:
        for t in (64999, 64998):
            TC.MessageMeta.registry.pop(t, None)


def test_field_order_rules():
    with pytest.raises(TypeError, match="must be the last field"):
        class _Bad(TC.Message):
            TYPE = 64997
            FIELDS = [("rest", "remainder"), ("x", "u8")]
    with pytest.raises(TypeError, match="not fixed-size"):
        class _BadArray(TC.Message):
            TYPE = 64996
            FIELDS = [("xs", "array:u8:varbytes")]
    for t in (64997, 64996):
        TC.MessageMeta.registry.pop(t, None)
