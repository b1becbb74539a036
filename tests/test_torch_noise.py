"""The port's ChaCha20-Poly1305 and BOLT #8 Noise against the JAX package's.

The C AEAD (native/chachapoly.c), its plain-Python version and the
`cryptography` package's ChaCha20Poly1305 agree byte for byte on seeded
inputs and on RFC 8439's vector; the port's handshake acts and transport
frames equal the JAX package's (which runs on `cryptography`) with the
same static and ephemeral keys, through the key rotation every 1,000
messages, and BOLT #8's own vectors.
"""
from __future__ import annotations

import random

import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

from lightning_tpu.bolt import noise as JN
from lightning_tpu_torch.bolt import noise as TN
from lightning_tpu_torch.crypto import chachapoly as CP
from lightning_tpu_torch.utils import native

LENGTHS = [0, 1, 2, 15, 16, 17, 63, 64, 65, 127, 129, 255, 1000, 4095,
           4096, 65535, 65551]
AD_LENGTHS = [0, 1, 15, 16, 17, 33, 64]

# RFC 8439 section 2.8.2
RFC_KEY = bytes(range(0x80, 0xA0))
RFC_NONCE = bytes.fromhex("070000004041424344454647")
RFC_AD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
RFC_CT = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116")
RFC_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")

# BOLT #8 (08-transport.md) test vectors
RS = 0x2121212121212121212121212121212121212121212121212121212121212121
LS = 0x1111111111111111111111111111111111111111111111111111111111111111
IE = 0x1212121212121212121212121212121212121212121212121212121212121212
RE = 0x2222222222222222222222222222222222222222222222222222222222222222
ACT1 = ("00036360e856310ce5d294e8be33fc807077dc56ac80d95d9cd4ddbd21325eff"
        "73f70df6086551151f58b8afe6c195782c6a")
ACT2 = ("0002466d7fcae563e5cb09a0d1870bb580344804617879a14949cf22285f1bae"
        "3f276e2470b93aac583c9ef6eafca3f730ae")
ACT3 = ("00b9e3a702e93e3a9948c2ed6e5fd7590a6e1c3a0344cfc9d5b57357049aa223"
        "55361aa02e55a8fc28fef5bd6d71ad0c38228dc68b1c466263b47fdf31e560e1"
        "39ba")
HELLO = {
    0: "cf2b30ddf0cf3f80e7c35a6e6730b59fe802473180f396d88a8fb0db8cbcf25d"
       "2f214cf9ea1d95",
    1: "72887022101f0b6753e0c7de21657d35a4cb2a1f5cde2650528bbc8f837d0f0d"
       "7ad833b1a256a1",
    500: "178cb9d7387190fa34db9c2d50027d21793c9bc2d40b1e14dcf30ebeeeb220f4"
         "8364f7a4c68bf8",
    501: "1b186c57d44eb6de4c057c49940d79bb838a145cb528d6e8fd26dbe50a60ca2c"
         "104b56b60e45bd",
    1000: "4a2f3cc3b5e78ddb83dcb426d9863d9d9a723b0337c89dd0b005d89f8d3c05c5"
          "2b76b29b740f09",
    1001: "2ecd8c8a5629d0d02ab457a0fdd0f7b90a192cd46be5ecb6ca570bfc5e268338"
          "b1a16cf4ef2d36",
}
ROTATION = sorted(HELLO)


@pytest.mark.parametrize("n", LENGTHS)
def test_aead_c_plain_and_cryptography_agree(n):
    rng = random.Random(n)
    for adl in AD_LENGTHS:
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        ad, pt = rng.randbytes(adl), rng.randbytes(n)
        want = ChaCha20Poly1305(key).encrypt(nonce, pt, ad)
        assert CP.encrypt(key, nonce, ad, pt) == want
        assert CP.decrypt(key, nonce, ad, want) == pt
        if n <= 4096 or adl in (0, 64):   # the plain version is slow
            assert CP.encrypt_plain(key, nonce, ad, pt) == want
            assert CP.decrypt_plain(key, nonce, ad, want) == pt


def test_rfc8439_aead_vector():
    want = RFC_CT + RFC_TAG
    assert ChaCha20Poly1305(RFC_KEY).encrypt(RFC_NONCE, RFC_PT,
                                             RFC_AD) == want
    assert CP.encrypt(RFC_KEY, RFC_NONCE, RFC_AD, RFC_PT) == want
    assert CP.encrypt_plain(RFC_KEY, RFC_NONCE, RFC_AD, RFC_PT) == want
    assert CP.decrypt(RFC_KEY, RFC_NONCE, RFC_AD, want) == RFC_PT
    assert CP.decrypt_plain(RFC_KEY, RFC_NONCE, RFC_AD, want) == RFC_PT


def test_rfc8439_chacha20_vector():
    """Section 2.4.2: block counter 1; the stream XOR the plaintext."""
    key = bytes(range(32))
    iv = (1).to_bytes(4, "little") + bytes.fromhex("000000000000004a00000000")
    ks = CP.chacha20_stream(key, iv, len(RFC_PT))
    ct = bytes(a ^ b for a, b in zip(RFC_PT, ks))
    assert ct[:32].hex() == ("6e2e359a2568f98041ba0728dd0d6981"
                             "e97e7aec1d4360c20a27afccfd9fae0b")
    assert ks == CP.chacha20_stream_plain(key, iv, len(RFC_PT))


@pytest.mark.parametrize("counter", [0, 1, 0xFFFFFFFE, 0xFFFFFFFF])
@pytest.mark.parametrize("n", [0, 1, 64, 65, 300])
def test_chacha20_stream_matches_cryptography(counter, n):
    rng = random.Random(counter ^ n)
    key = rng.randbytes(32)
    iv = counter.to_bytes(4, "little") + rng.randbytes(12)
    want = Cipher(algorithms.ChaCha20(key, iv), mode=None).encryptor() \
        .update(b"\x00" * n)
    assert CP.chacha20_stream(key, iv, n) == want
    assert CP.chacha20_stream_plain(key, iv, n) == want


@pytest.mark.parametrize("decrypt", [CP.decrypt, CP.decrypt_plain],
                         ids=["c", "plain"])
@pytest.mark.parametrize("where", ["tag", "body", "ad"])
def test_flipped_bit_raises(decrypt, where):
    rng = random.Random(5)
    key, nonce = rng.randbytes(32), rng.randbytes(12)
    ad, pt = rng.randbytes(13), rng.randbytes(77)
    ct = bytearray(CP.encrypt(key, nonce, ad, pt))
    if where == "tag":
        ct[-1] ^= 0x80
    elif where == "body":
        ct[3] ^= 0x01
    else:
        ad = bytes([ad[0] ^ 0x01]) + ad[1:]
    with pytest.raises(CP.TagError):
        decrypt(key, nonce, ad, bytes(ct))
    with pytest.raises(CP.TagError):
        decrypt(key, nonce, ad, bytes(ct[:15]))


def _handshake(N):
    rs, ls = N.Keypair(RS), N.Keypair(LS)
    ie, re = N.Keypair(IE), N.Keypair(RE)
    act1, on_act2 = N.initiator_handshake(ls, ie, rs.pub)
    act2, on_act3 = N.responder_handshake(rs, re)(act1)
    act3, ikeys = on_act2(act2)
    return (act1, act2, act3), ikeys, on_act3(act3)


def test_bolt8_handshake_vectors_and_parity():
    acts, ikeys, rkeys = _handshake(TN)
    assert [a.hex() for a in acts] == [ACT1, ACT2, ACT3]
    jacts, jikeys, jrkeys = _handshake(JN)
    assert acts == jacts
    assert (ikeys.sk, ikeys.rk, ikeys.ck) == (jikeys.sk, jikeys.rk,
                                               jikeys.ck)
    assert (rkeys.sk, rkeys.rk) == (ikeys.rk, ikeys.sk)
    assert ikeys.sk.hex() == ("969ab31b4d288cedf6218839b27a3e21"
                              "40827047f2c0f01bf5c04435d43511a9")


def test_bolt8_message_vectors_through_rotation():
    _, ikeys, rkeys = _handshake(TN)
    send, recv = TN.CryptoMsg(ikeys), TN.CryptoMsg(rkeys)
    for i in range(ROTATION[-1] + 1):
        frame = send.encrypt(b"hello")
        if i in HELLO:
            assert frame.hex() == HELLO[i]
        assert recv.decrypt(frame) == b"hello"


@pytest.mark.parametrize("direction", ["initiator", "responder"])
def test_frames_match_jax_package_through_rotation(direction):
    """Seeded messages of seeded lengths, 1,002 a side: every frame
    byte-identical, and each package decrypts the other's."""
    _, tik, trk = _handshake(TN)
    _, jik, jrk = _handshake(JN)
    pick = 0 if direction == "initiator" else 1
    t_send = TN.CryptoMsg((tik, trk)[pick])
    t_recv = TN.CryptoMsg((trk, tik)[pick])
    j_send = JN.CryptoMsg((jik, jrk)[pick])
    j_recv = JN.CryptoMsg((jrk, jik)[pick])
    rng = random.Random(pick)
    for i in range(ROTATION[-1] + 1):
        msg = rng.randbytes(rng.choice((0, 2, 40, 136, 430, 65535)
                                       if i in ROTATION else (2, 136)))
        frame = t_send.encrypt(msg)
        assert frame == j_send.encrypt(msg), f"frame {i}"
        assert j_recv.decrypt(frame) == msg
        assert t_recv.decrypt(frame) == msg
    assert t_send.sn == j_send.sn and t_send.sk == j_send.sk


def test_tampered_frame_raises_handshake_error():
    _, ikeys, rkeys = _handshake(TN)
    a, b = TN.CryptoMsg(ikeys), TN.CryptoMsg(rkeys)
    frame = bytearray(a.encrypt(b"hello"))
    frame[-1] ^= 1
    with pytest.raises(TN.HandshakeError):
        b.decrypt(bytes(frame))


def test_wrong_responder_key_fails():
    rs, wrong = TN.Keypair(5), TN.Keypair(6)
    ls, ie, re = TN.Keypair(7), TN.Keypair(8), TN.Keypair(9)
    act1, _ = TN.initiator_handshake(ls, ie, wrong.pub)
    with pytest.raises(TN.HandshakeError):
        TN.responder_handshake(rs, re)(act1)


def test_bad_act_framing_rejected():
    rs, re = TN.Keypair(5), TN.Keypair(9)
    act1, _ = TN.initiator_handshake(TN.Keypair(7), TN.Keypair(8), rs.pub)
    for bad in (act1[:-1], b"\x01" + act1[1:]):
        with pytest.raises(TN.HandshakeError, match="bad act1"):
            TN.responder_handshake(rs, re)(bad)


def test_no_quiet_fallback_when_the_c_library_fails(monkeypatch):
    """A C library that does not build makes the call raise; nothing
    falls back to the plain-Python cipher."""
    def broken():
        raise OSError("cc: not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", broken)
    with pytest.raises(OSError, match="cc: not found"):
        CP.encrypt(b"\x00" * 32, b"\x00" * 12, b"", b"x")
    with pytest.raises(OSError, match="cc: not found"):
        CP.chacha20_stream(b"\x00" * 32, b"\x00" * 16, 5)
