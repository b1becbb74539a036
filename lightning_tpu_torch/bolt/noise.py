"""BOLT#8 Noise_XK transport: handshake + AEAD message framing.

Functional equivalent of the reference's connectd/handshake.c (3-act
Noise_XK with secp256k1 / ChaChaPoly / SHA256) and common/cryptomsg.c
(length-prefixed AEAD framing with key rotation every 1000 messages).
Written from the BOLT#8 spec.

This is per-connection serial host work, so it stays on the CPU: the
AEAD is the port's own ChaCha20-Poly1305 in C (crypto/chachapoly.py), and
the handful of ECDH point-multiplies per handshake use exact-int host
math (crypto/ref_python.py).  The port's own copy of the JAX package's
bolt/noise.py; acts and frames are byte-identical to its.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
from dataclasses import dataclass

from ..crypto import chachapoly as aead
from ..crypto import ref_python as ref

PROTOCOL_NAME = b"Noise_XK_secp256k1_ChaChaPoly_SHA256"
PROLOGUE = b"lightning"
ACT_ONE_SIZE = 50
ACT_TWO_SIZE = 50
ACT_THREE_SIZE = 66
REKEY_INTERVAL = 1000


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def hkdf2(salt: bytes, ikm: bytes) -> tuple[bytes, bytes]:
    """HKDF-SHA256, zero info, 64 bytes out split in two (BOLT#8)."""
    prk = hmac_mod.new(salt, ikm, hashlib.sha256).digest()
    t1 = hmac_mod.new(prk, b"\x01", hashlib.sha256).digest()
    t2 = hmac_mod.new(prk, t1 + b"\x02", hashlib.sha256).digest()
    return t1, t2


def ecdh(privkey: int, pubkey: ref.Point) -> bytes:
    """BOLT#8 ECDH: sha256 of the compressed shared point."""
    return sha256(ref.pubkey_serialize(ref.point_mul(privkey, pubkey)))


def _nonce(n: int) -> bytes:
    return b"\x00" * 4 + n.to_bytes(8, "little")


def encrypt_with_ad(key: bytes, nonce: int, ad: bytes, plaintext: bytes) -> bytes:
    return aead.encrypt(key, _nonce(nonce), ad, plaintext)


def decrypt_with_ad(key: bytes, nonce: int, ad: bytes, ciphertext: bytes) -> bytes:
    try:
        return aead.decrypt(key, _nonce(nonce), ad, ciphertext)
    except aead.TagError:
        # normalize to our own error so transport/peer layers can handle
        # "bad bytes from the network" as one error
        raise HandshakeError("AEAD tag failure") from None


@dataclass
class Keypair:
    priv: int
    pub: ref.Point = None

    def __post_init__(self):
        if self.pub is None:
            self.pub = ref.pubkey_create(self.priv)

    @property
    def pub_bytes(self) -> bytes:
        return ref.pubkey_serialize(self.pub)


class HandshakeError(Exception):
    pass


class HandshakeState:
    """Symmetric+handshake state shared by both roles."""

    def __init__(self, responder_pub: ref.Point):
        self.ck = sha256(PROTOCOL_NAME)
        self.h = sha256(self.ck + PROLOGUE)
        self.mix_hash(ref.pubkey_serialize(responder_pub))
        self.temp_k2: bytes | None = None

    def mix_hash(self, data: bytes):
        self.h = sha256(self.h + data)

    def mix_key(self, ikm: bytes) -> bytes:
        self.ck, temp_k = hkdf2(self.ck, ikm)
        return temp_k


@dataclass
class TransportKeys:
    sk: bytes  # sending key
    rk: bytes  # receiving key
    ck: bytes  # chaining key for rotation
    remote_pub: ref.Point


def initiator_act1(hs: HandshakeState, e: Keypair, rs: ref.Point) -> bytes:
    hs.mix_hash(e.pub_bytes)
    temp_k1 = hs.mix_key(ecdh(e.priv, rs))
    c = encrypt_with_ad(temp_k1, 0, hs.h, b"")
    hs.mix_hash(c)
    return b"\x00" + e.pub_bytes + c


def responder_act1(hs: HandshakeState, s: Keypair, act1: bytes) -> ref.Point:
    if len(act1) != ACT_ONE_SIZE or act1[0] != 0:
        raise HandshakeError("bad act1")
    re_pub = ref.pubkey_parse(act1[1:34])
    hs.mix_hash(act1[1:34])
    temp_k1 = hs.mix_key(ecdh(s.priv, re_pub))
    decrypt_with_ad(temp_k1, 0, hs.h, act1[34:])  # raises on tag failure
    hs.mix_hash(act1[34:])
    return re_pub


def responder_act2(hs: HandshakeState, e: Keypair, re_pub: ref.Point) -> bytes:
    hs.mix_hash(e.pub_bytes)
    hs.temp_k2 = hs.mix_key(ecdh(e.priv, re_pub))
    c = encrypt_with_ad(hs.temp_k2, 0, hs.h, b"")
    hs.mix_hash(c)
    return b"\x00" + e.pub_bytes + c


def initiator_act2(hs: HandshakeState, e: Keypair, act2: bytes) -> ref.Point:
    if len(act2) != ACT_TWO_SIZE or act2[0] != 0:
        raise HandshakeError("bad act2")
    re_pub = ref.pubkey_parse(act2[1:34])
    hs.mix_hash(act2[1:34])
    hs.temp_k2 = hs.mix_key(ecdh(e.priv, re_pub))
    decrypt_with_ad(hs.temp_k2, 0, hs.h, act2[34:])
    hs.mix_hash(act2[34:])
    return re_pub


def initiator_act3(hs: HandshakeState, s: Keypair, re_pub: ref.Point) -> tuple[bytes, TransportKeys]:
    c = encrypt_with_ad(hs.temp_k2, 1, hs.h, s.pub_bytes)
    hs.mix_hash(c)
    temp_k3 = hs.mix_key(ecdh(s.priv, re_pub))
    t = encrypt_with_ad(temp_k3, 0, hs.h, b"")
    sk, rk = hkdf2(hs.ck, b"")
    return b"\x00" + c + t, TransportKeys(sk, rk, hs.ck, re_pub)


def responder_act3(hs: HandshakeState, e: Keypair, act3: bytes) -> TransportKeys:
    if len(act3) != ACT_THREE_SIZE or act3[0] != 0:
        raise HandshakeError("bad act3")
    c, t = act3[1:50], act3[50:]
    rs_bytes = decrypt_with_ad(hs.temp_k2, 1, hs.h, c)
    rs_pub = ref.pubkey_parse(rs_bytes)
    hs.mix_hash(c)
    temp_k3 = hs.mix_key(ecdh(e.priv, rs_pub))
    decrypt_with_ad(temp_k3, 0, hs.h, t)
    rk, sk = hkdf2(hs.ck, b"")
    return TransportKeys(sk, rk, hs.ck, rs_pub)


def initiator_handshake(s: Keypair, e: Keypair, responder_pub: ref.Point):
    """Returns (act1_bytes, continuation) — continuation(act2) → (act3, keys)."""
    hs = HandshakeState(responder_pub)
    act1 = initiator_act1(hs, e, responder_pub)

    def on_act2(act2: bytes):
        re_pub = initiator_act2(hs, e, act2)
        act3, keys = initiator_act3(hs, s, re_pub)
        # the peer's identity is its static key (known a priori in XK),
        # not the ephemeral used for act2
        keys.remote_pub = responder_pub
        return act3, keys

    return act1, on_act2


def responder_handshake(s: Keypair, e: Keypair):
    """Returns continuation(act1) → (act2, continuation2(act3) → keys)."""
    hs = HandshakeState(s.pub)

    def on_act1(act1: bytes):
        re_pub = responder_act1(hs, s, act1)
        act2 = responder_act2(hs, e, re_pub)

        def on_act3(act3: bytes):
            return responder_act3(hs, e, act3)

        return act2, on_act3

    return on_act1


class CryptoMsg:
    """Post-handshake AEAD framing (common/cryptomsg.c equivalent):
    2-byte big-endian length encrypted+tagged, then payload encrypted+
    tagged; independent nonce counters; rekey every 1000 messages."""

    def __init__(self, keys: TransportKeys):
        self.sk, self.rk, self.ck = keys.sk, keys.rk, keys.ck
        self.sck = self.rck = self.ck
        self.sn = self.rn = 0
        self.remote_pub = keys.remote_pub

    def _maybe_rotate_send(self):
        if self.sn == REKEY_INTERVAL:
            self.sck, self.sk = hkdf2(self.sck, self.sk)
            self.sn = 0

    def _maybe_rotate_recv(self):
        if self.rn == REKEY_INTERVAL:
            self.rck, self.rk = hkdf2(self.rck, self.rk)
            self.rn = 0

    def encrypt(self, msg: bytes) -> bytes:
        if len(msg) > 65535:
            raise ValueError("message too long")
        self._maybe_rotate_send()
        lc = encrypt_with_ad(self.sk, self.sn, b"", len(msg).to_bytes(2, "big"))
        self.sn += 1
        mc = encrypt_with_ad(self.sk, self.sn, b"", msg)
        self.sn += 1
        return lc + mc

    def decrypt_length(self, hdr: bytes) -> int:
        self._maybe_rotate_recv()
        ln = decrypt_with_ad(self.rk, self.rn, b"", hdr)
        self.rn += 1
        return int.from_bytes(ln, "big")

    def decrypt_body(self, body: bytes) -> bytes:
        msg = decrypt_with_ad(self.rk, self.rn, b"", body)
        self.rn += 1
        return msg

    def decrypt(self, frame: bytes) -> bytes:
        ln = self.decrypt_length(frame[:18])
        if len(frame) != 18 + ln + 16:
            raise ValueError("frame length mismatch")
        return self.decrypt_body(frame[18:])
