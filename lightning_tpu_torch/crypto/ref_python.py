"""Pure-Python secp256k1 oracle (host-side, exact integers).

The port's own copy of the exact-int reference.  It exists to:
  * give ground truth for the plain PyTorch versions and the CUDA kernels,
  * build the fixed-base window tables on the host,
  * check a sample of the card's verdicts signature by signature.

Semantics follow Core Lightning's crypto surface (bitcoin/signature.c
sign_hash / check_signed_hash / check_schnorr_sig), written from the
public SEC1 / RFC6979 / BIP340 specifications using Python bigints.
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

# Curve constants (SEC2: secp256k1).
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7


def fe_inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


@dataclass(frozen=True)
class Point:
    """Affine point; None-coords encode infinity via the INFINITY sentinel."""

    x: int
    y: int
    inf: bool = False


INFINITY = Point(0, 0, True)
G = Point(GX, GY)


def is_on_curve(pt: Point) -> bool:
    if pt.inf:
        return True
    return (pt.y * pt.y - pt.x * pt.x * pt.x - B) % P == 0


def point_add(p1: Point, p2: Point) -> Point:
    if p1.inf:
        return p2
    if p2.inf:
        return p1
    if p1.x == p2.x:
        if (p1.y + p2.y) % P == 0:
            return INFINITY
        return point_double(p1)
    lam = (p2.y - p1.y) * fe_inv(p2.x - p1.x) % P
    x3 = (lam * lam - p1.x - p2.x) % P
    y3 = (lam * (p1.x - x3) - p1.y) % P
    return Point(x3, y3)


def point_double(p1: Point) -> Point:
    if p1.inf or p1.y == 0:
        return INFINITY
    lam = 3 * p1.x * p1.x * fe_inv(2 * p1.y) % P
    x3 = (lam * lam - 2 * p1.x) % P
    y3 = (lam * (p1.x - x3) - p1.y) % P
    return Point(x3, y3)


def _jac_double(X: int, Y: int, Z: int) -> tuple[int, int, int]:
    """Jacobian doubling (x = X/Z^2, y = Y/Z^3); Z = 0 is infinity."""
    if Y == 0 or Z == 0:
        return 1, 1, 0
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P


def _jac_add_affine(X1: int, Y1: int, Z1: int,
                    pt: Point) -> tuple[int, int, int]:
    """Jacobian + affine, with point_add's cases: equal x gives infinity
    where the y sum is 0 mod p and the doubling otherwise."""
    if Z1 == 0:
        return pt.x, pt.y, 1
    Z1Z1 = Z1 * Z1 % P
    H = (pt.x * Z1Z1 - X1) % P
    S2 = pt.y * Z1 * Z1Z1 % P
    if H == 0:
        if (S2 + Y1) % P == 0:
            return 1, 1, 0
        return _jac_double(X1, Y1, Z1)
    r = (S2 - Y1) % P
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return X3, (r * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def point_mul(k: int, pt: Point) -> Point:
    """k * pt by double-and-add in Jacobian coordinates, one inversion at
    the end (the affine chain's values, about 10x faster in Python)."""
    k %= N
    if pt.inf or k == 0:
        return INFINITY
    X, Y, Z = 1, 1, 0
    for i in range(k.bit_length() - 1, -1, -1):
        X, Y, Z = _jac_double(X, Y, Z)
        if (k >> i) & 1:
            X, Y, Z = _jac_add_affine(X, Y, Z, pt)
    if Z == 0:
        return INFINITY
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return Point(X * zi2 % P, Y * zi2 * zi % P)


def point_neg(pt: Point) -> Point:
    if pt.inf:
        return pt
    return Point(pt.x, (-pt.y) % P)


# ---------------------------------------------------------------------------
# Serialization


def pubkey_serialize(pt: Point) -> bytes:
    """SEC1 compressed 33-byte encoding."""
    assert not pt.inf
    return bytes([2 + (pt.y & 1)]) + pt.x.to_bytes(32, "big")


def pubkey_parse(data: bytes) -> Point:
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        y2 = (pow(x, 3, P) + B) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            raise ValueError("not on curve")
        if (y & 1) != (data[0] & 1):
            y = P - y
        return Point(x, y)
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        pt = Point(x, y)
        if not is_on_curve(pt):
            raise ValueError("not on curve")
        return pt
    raise ValueError("bad pubkey encoding")


def pubkey_create(seckey: int) -> Point:
    assert 0 < seckey < N
    return point_mul(seckey, G)


# ---------------------------------------------------------------------------
# ECDSA (mirrors check_signed_hash / sign_hash semantics)


def ecdsa_verify(msg_hash: bytes, r: int, s: int, pubkey: Point) -> bool:
    """Verify an ECDSA signature over a 32-byte hash.

    Matches libsecp256k1's secp256k1_ecdsa_verify as called from the
    reference's check_signed_hash (bitcoin/signature.c:174): upstream
    returns 0 for non-normalized (high-S) signatures, so s > n/2 is
    rejected here too.
    """
    if not (0 < r < N and 0 < s <= N // 2):
        return False
    if pubkey.inf or not is_on_curve(pubkey):
        return False
    z = int.from_bytes(msg_hash, "big")
    w = pow(s, -1, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = point_add(point_mul(u1, G), point_mul(u2, pubkey))
    if pt.inf:
        return False
    return pt.x % N == r


def rfc6979_nonce(msg_hash: bytes, seckey: int, extra: bytes | None = None) -> int:
    """RFC6979 deterministic nonce (HMAC-SHA256), with optional 32-byte
    extra data (libsecp256k1's ndata, used for low-R grinding counters)."""
    x = seckey.to_bytes(32, "big")
    data = x + msg_hash + (extra if extra is not None else b"")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + data, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + data, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        nonce = int.from_bytes(v, "big")
        if 0 < nonce < N:
            return nonce
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(msg_hash: bytes, seckey: int, grind_low_r: bool = True) -> tuple[int, int]:
    """Deterministic ECDSA sign with low-S normalization and (optionally)
    low-R grinding, matching the reference's sign_hash
    (bitcoin/signature.c:97-118: retries with a counter in ndata until the
    signature's R has no leading zero-padding, i.e. r < 2^255 top byte < 0x80)."""
    z = int.from_bytes(msg_hash, "big")
    counter = 0
    while True:
        extra = None if counter == 0 else counter.to_bytes(32, "little")
        k = rfc6979_nonce(msg_hash, seckey, extra)
        pt = point_mul(k, G)
        r = pt.x % N
        if r == 0:
            counter += 1
            continue
        s = pow(k, -1, N) * (z + r * seckey) % N
        if s == 0:
            counter += 1
            continue
        if s > N // 2:
            s = N - s
        if grind_low_r and r >> 248 >= 0x80:
            counter += 1
            continue
        return r, s


# ---------------------------------------------------------------------------
# BIP340 Schnorr


def tagged_hash(tag: str, data: bytes) -> bytes:
    th = hashlib.sha256(tag.encode()).digest()
    return hashlib.sha256(th + th + data).digest()


def lift_x(x: int) -> Point | None:
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if y & 1:
        y = P - y
    return Point(x, y)


def schnorr_verify(msg: bytes, pubkey_x: int, sig: bytes) -> bool:
    """BIP340 verify; msg is the (any-length) message, per check_schnorr_sig
    (bitcoin/signature.c:408) it is always a 32-byte hash in the reference."""
    if len(sig) != 64:
        return False
    pk = lift_x(pubkey_x)
    if pk is None:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if r >= P or s >= N:
        return False
    e = (
        int.from_bytes(
            tagged_hash(
                "BIP0340/challenge",
                sig[:32] + pubkey_x.to_bytes(32, "big") + msg,
            ),
            "big",
        )
        % N
    )
    pt = point_add(point_mul(s, G), point_mul(N - e, pk))
    if pt.inf or pt.y & 1:
        return False
    return pt.x == r


def schnorr_sign(msg: bytes, seckey: int, aux: bytes = b"\x00" * 32) -> bytes:
    """BIP340 sign with auxiliary randomness."""
    d = seckey
    pt = point_mul(d, G)
    if pt.y & 1:
        d = N - d
    t = d ^ int.from_bytes(tagged_hash("BIP0340/aux", aux), "big")
    k0 = (
        int.from_bytes(
            tagged_hash(
                "BIP0340/nonce",
                t.to_bytes(32, "big") + pt.x.to_bytes(32, "big") + msg,
            ),
            "big",
        )
        % N
    )
    if k0 == 0:
        raise ValueError("zero nonce")
    rpt = point_mul(k0, G)
    k = N - k0 if rpt.y & 1 else k0
    e = (
        int.from_bytes(
            tagged_hash(
                "BIP0340/challenge",
                rpt.x.to_bytes(32, "big") + pt.x.to_bytes(32, "big") + msg,
            ),
            "big",
        )
        % N
    )
    sig = rpt.x.to_bytes(32, "big") + ((k + e * d) % N).to_bytes(32, "big")
    assert schnorr_verify(msg, pt.x, sig)
    return sig


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()
