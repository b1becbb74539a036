"""BOLT#3 key derivation: per-commitment points, derived basepoint keys,
revocation keys, and the shachain (per-commitment secret tree).

Parity targets: common/derive_basepoints.c and ccan/crypto/shachain in
the reference (re-implemented from the BOLT#3 spec).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto import ref_python as ref

SHACHAIN_BITS = 48
LARGEST_INDEX = (1 << SHACHAIN_BITS) - 1


def sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def per_commitment_point(secret: bytes) -> ref.Point:
    return ref.pubkey_create(int.from_bytes(secret, "big") % ref.N)


def derive_pubkey(basepoint: ref.Point, per_commitment: ref.Point) -> ref.Point:
    """pubkey = basepoint + SHA256(per_commitment_point || basepoint)·G."""
    t = sha256(ref.pubkey_serialize(per_commitment) + ref.pubkey_serialize(basepoint))
    return ref.point_add(basepoint, ref.point_mul(int.from_bytes(t, "big") % ref.N, ref.G))


def derive_privkey(base_secret: int, per_commitment: ref.Point) -> int:
    basepoint = ref.pubkey_create(base_secret)
    t = sha256(ref.pubkey_serialize(per_commitment) + ref.pubkey_serialize(basepoint))
    return (base_secret + int.from_bytes(t, "big")) % ref.N


def derive_revocation_pubkey(revocation_basepoint: ref.Point,
                             per_commitment: ref.Point) -> ref.Point:
    """revocationpubkey = revocation_basepoint×h1 + per_commitment_point×h2
    with h1 = SHA256(revocation_basepoint || per_commitment_point),
         h2 = SHA256(per_commitment_point || revocation_basepoint)."""
    rb = ref.pubkey_serialize(revocation_basepoint)
    pc = ref.pubkey_serialize(per_commitment)
    h1 = int.from_bytes(sha256(rb + pc), "big") % ref.N
    h2 = int.from_bytes(sha256(pc + rb), "big") % ref.N
    return ref.point_add(
        ref.point_mul(h1, revocation_basepoint), ref.point_mul(h2, per_commitment)
    )


def derive_revocation_privkey(revocation_base_secret: int,
                              per_commitment_secret: int) -> int:
    rb = ref.pubkey_serialize(ref.pubkey_create(revocation_base_secret))
    pc = ref.pubkey_serialize(ref.pubkey_create(per_commitment_secret))
    h1 = int.from_bytes(sha256(rb + pc), "big") % ref.N
    h2 = int.from_bytes(sha256(pc + rb), "big") % ref.N
    return (revocation_base_secret * h1 + per_commitment_secret * h2) % ref.N


@dataclass
class Basepoints:
    """One side's channel basepoints (the reference derives these from the
    hsm seed per channel; common/derive_basepoints.c)."""

    funding_pubkey: ref.Point
    revocation: ref.Point
    payment: ref.Point
    delayed_payment: ref.Point
    htlc: ref.Point


@dataclass
class BaseSecrets:
    funding: int
    revocation: int
    payment: int
    delayed_payment: int
    htlc: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "BaseSecrets":
        def k(tag: bytes) -> int:
            v = int.from_bytes(sha256(seed + tag), "big") % ref.N
            return v or 1

        return cls(k(b"funding"), k(b"revocation"), k(b"payment"),
                   k(b"delayed"), k(b"htlc"))

    def basepoints(self) -> Basepoints:
        return Basepoints(
            ref.pubkey_create(self.funding),
            ref.pubkey_create(self.revocation),
            ref.pubkey_create(self.payment),
            ref.pubkey_create(self.delayed_payment),
            ref.pubkey_create(self.htlc),
        )


# ---------------------------------------------------------------------------
# Shachain (BOLT#3 "per-commitment secret requirements")


def shachain_derive_secret(seed: bytes, index: int) -> bytes:
    """generate_from_seed(seed, I): flip bit B for each set bit of I
    (MSB-first over 48 bits), hashing after each flip."""
    p = bytearray(seed)
    for b in range(SHACHAIN_BITS - 1, -1, -1):
        if (index >> b) & 1:
            p[b // 8] ^= 1 << (b % 8)
            p = bytearray(sha256(bytes(p)))
    return bytes(p)


def _derive(from_index: int, to_index: int, from_secret: bytes) -> bytes:
    """Derive to_index's secret from from_index's (from must be a prefix)."""
    branches = from_index ^ to_index
    p = bytearray(from_secret)
    for b in range(SHACHAIN_BITS - 1, -1, -1):
        if (branches >> b) & 1:
            p[b // 8] ^= 1 << (b % 8)
            p = bytearray(sha256(bytes(p)))
    return bytes(p)


def _zeros_below(index: int, bits: int) -> bool:
    return (index & ((1 << bits) - 1)) == 0


class ShachainReceiver:
    """O(log n) storage of received per-commitment secrets, newest-first
    (indices count down from 2^48-1 in the sender's numbering; we store by
    the BOLT's decreasing index convention).

    insert() returns False if the secret is inconsistent with previously
    received ones (the peer lied — channel must fail)."""

    def __init__(self):
        # slot b holds (index, secret) where index has exactly b trailing
        # zero-bits "capacity"
        self.known: list[tuple[int, bytes] | None] = [None] * (SHACHAIN_BITS + 1)
        self.max_index: int | None = None

    @staticmethod
    def _slot(index: int) -> int:
        if index == 0:
            return SHACHAIN_BITS
        b = 0
        while not (index >> b) & 1:
            b += 1
        return b

    def insert(self, index: int, secret: bytes) -> bool:
        slot = self._slot(index)
        # every stored secret with fewer trailing zeros must be derivable
        for b in range(slot):
            if self.known[b] is not None:
                idx_b, sec_b = self.known[b]
                if _derive(index, idx_b, secret) != sec_b:
                    return False
        self.known[slot] = (index, secret)
        for b in range(slot):
            self.known[b] = None
        self.max_index = index if self.max_index is None else min(self.max_index, index)
        return True

    def lookup(self, index: int) -> bytes | None:
        for b in range(SHACHAIN_BITS + 1):
            if self.known[b] is None:
                continue
            idx_b, sec_b = self.known[b]
            mask = ~((1 << b) - 1) & LARGEST_INDEX
            if (index & mask) == idx_b and index >= idx_b:
                return _derive(idx_b, index, sec_b)
        return None
