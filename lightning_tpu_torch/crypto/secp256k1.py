"""Batched secp256k1 in plain PyTorch: ECDSA verify, ECDSA sign, k*G and
BIP340 verify.

Points are homogeneous projective (X:Y:Z) tuples of (B, 20) radix-2^13
limb tensors; infinity is (0:1:0).  Point operations use the
Renes-Costello-Batina complete formulas for a = 0, which have no
exceptional cases, so one code path serves every input.

The kernels' plain versions in ``hopper_secp`` are built from these
ops.  ``dual_mul`` (the 64-window scan without GLV, the ``xla`` engine)
and ``decompress`` (with ``field.inv_batch``, the ``xla`` prep) are the
JAX package's XLA stages and stay plain PyTorch on the card;
``host_verify_batch`` is the exact-int oracle the verify path is held
against.

The sign half (``fixed_base_mul`` on the comb table, ``ecdsa_sign_kernel``
with its four-candidate low-R rule, ``ecdsa_sign_simple_kernel``,
``derive_pubkeys_kernel``) is an XLA program in the JAX package; here it
is the plain version of the kernels S1 (``csrc/fixed_base.cu``) and S2
(``csrc/ecdsa_sign.cu``).  ``schnorr_verify_kernel`` takes its u1*G +
u2*P from the caller (the engines' main-path scan).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import ref_python as ref
from .field import FN, FP, NLIMBS

P_INT = F.P_INT
N_INT = F.N_INT
B3 = 21  # 3*b for y^2 = x^3 + 7
WINDOW = 4
NDIGITS = 256 // WINDOW


def _add(a, b):
    return F.add(FP, a, b)


def _sub(a, b):
    return F.sub(FP, a, b)


def _mul(a, b):
    return F.mul(FP, a, b)


def _sqr(a):
    return F.mul(FP, a, a)


def _b3(a):
    return F.mul_small(FP, a, B3)


# ---------------------------------------------------------------------------
# Constant tables (host-side, exact integers)


@functools.lru_cache(maxsize=1)
def _comb_table() -> np.ndarray:
    """(64, 16, 2, NLIMBS) int64: entry [j][v] = affine (x, y) of
    v * 2^(4j) * G; the v = 0 entries are zeros, never read (a window
    whose digit is 0 adds nothing)."""
    table = np.zeros((NDIGITS, 16, 2, NLIMBS), dtype=np.int64)
    base = ref.G
    for j in range(NDIGITS):
        acc = ref.INFINITY
        for v in range(1, 16):
            acc = ref.point_add(acc, base)
            table[j, v, 0] = F.int_to_limbs(acc.x)
            table[j, v, 1] = F.int_to_limbs(acc.y)
        for _ in range(WINDOW):
            base = ref.point_double(base)
    return table


@functools.lru_cache(maxsize=1)
def _g_window_proj() -> np.ndarray:
    """(16, 3, NLIMBS) projective window table for G: entry v = v*G with
    Z = 1, entry 0 = (0:1:0)."""
    out = np.zeros((16, 3, NLIMBS), dtype=np.int64)
    out[0, 1, 0] = 1
    acc = ref.INFINITY
    for v in range(1, 16):
        acc = ref.point_add(acc, ref.G)
        out[v, 0] = F.int_to_limbs(acc.x)
        out[v, 1] = F.int_to_limbs(acc.y)
        out[v, 2, 0] = 1
    return out


# ---------------------------------------------------------------------------
# Complete projective point ops (RCB, a = 0)


def point_inf(shape=(), device="cpu"):
    return (F.zero(shape, device), F.one(shape, device), F.zero(shape, device))


def point_double(p):
    """RCB complete doubling (alg 9): 8 multiplications + 1 small."""
    X, Y, Z = p
    t0 = _sqr(Y)
    Z3 = _add(t0, t0)
    Z3 = _add(Z3, Z3)
    Z3 = _add(Z3, Z3)
    t1 = _mul(Y, Z)
    t2 = _sqr(Z)
    t2 = _b3(t2)
    X3 = _mul(t2, Z3)
    Y3 = _add(t0, t2)
    Z3 = _mul(t1, Z3)
    t1 = _add(t2, t2)
    t2 = _add(t1, t2)
    t0 = _sub(t0, t2)
    Y3 = _mul(t0, Y3)
    Y3 = _add(X3, Y3)
    t1 = _mul(X, Y)
    X3 = _mul(t0, t1)
    X3 = _add(X3, X3)
    return (X3, Y3, Z3)


def point_add(p1, p2):
    """RCB complete addition (alg 7): 12 multiplications + 2 small."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0 = _mul(X1, X2)
    t1 = _mul(Y1, Y2)
    t2 = _mul(Z1, Z2)
    t3 = _add(X1, Y1)
    t4 = _add(X2, Y2)
    t3 = _mul(t3, t4)
    t4 = _add(t0, t1)
    t3 = _sub(t3, t4)
    t4 = _add(Y1, Z1)
    X3 = _add(Y2, Z2)
    t4 = _mul(t4, X3)
    X3 = _add(t1, t2)
    t4 = _sub(t4, X3)
    X3 = _add(X1, Z1)
    Y3 = _add(X2, Z2)
    X3 = _mul(X3, Y3)
    Y3 = _add(t0, t2)
    Y3 = _sub(X3, Y3)
    X3 = _add(t0, t0)
    t0 = _add(X3, t0)
    t2 = _b3(t2)
    Z3 = _add(t1, t2)
    t1 = _sub(t1, t2)
    Y3 = _b3(Y3)
    X3 = _mul(t4, Y3)
    t2 = _mul(t3, t1)
    X3 = _sub(t2, X3)
    Y3 = _mul(Y3, t0)
    t1 = _mul(t1, Z3)
    Y3 = _add(t1, Y3)
    t0 = _mul(t0, t3)
    Z3 = _mul(Z3, t4)
    Z3 = _add(Z3, t0)
    return (X3, Y3, Z3)


def point_to_affine(p):
    """(x, y) = (X / Z, Y / Z) by the batched inversion; infinity gives
    (0, 0) (the inv(0) = 0 convention)."""
    X, Y, Z = p
    zi = F.inv_batch(FP, Z)
    return _mul(X, zi), _mul(Y, zi)


# ---------------------------------------------------------------------------
# Scalar digits and window tables


def digits4(scalar, ndig: int = NDIGITS):
    """Canonical scalar limbs -> (..., ndig) 4-bit digits, LSB first."""
    bits = F.canonical_bits(scalar, 4 * ndig)
    nib = bits.reshape(*bits.shape[:-1], ndig, 4)
    return (nib * torch.tensor([1, 2, 4, 8], device=scalar.device)).sum(-1)


def _table_lookup(table, idx):
    """table: (B, 16, 3, NLIMBS); idx: (B,) -> 3 coords (B, NLIMBS)."""
    sel = table[torch.arange(table.shape[0], device=table.device), idx]
    return sel[:, 0], sel[:, 1], sel[:, 2]


def _shared_table_lookup(table, idx):
    """table: (nv, 3, NLIMBS) shared across the batch; idx: (B,)."""
    sel = table[idx]
    return sel[:, 0], sel[:, 1], sel[:, 2]


def _build_window(qx, qy):
    """Per-element window table T[v] = v*Q, v = 0..15: (B, 16, 3, NLIMBS)."""
    B = qx.shape[0]
    entries = [point_inf((B,), qx.device), (qx, qy, F.one((B,), qx.device))]
    for v in range(2, 16):
        entries.append(point_add(entries[v - 1], entries[1]))
    return torch.stack([torch.stack(e, dim=-2) for e in entries], dim=-3)


def dual_mul(u1, u2, qx, qy):
    """u1*G + u2*Q over a 64-window scan (u1, u2 canonical limbs; qx, qy
    affine limbs).  Returns a projective point tuple."""
    qtab = _build_window(qx, qy)
    gtab = torch.as_tensor(_g_window_proj(), device=u1.device)
    d1 = digits4(u1).flip(-1)
    d2 = digits4(u2).flip(-1)
    acc = point_inf((u1.shape[0],), u1.device)
    for w in range(NDIGITS):
        for _ in range(WINDOW):
            acc = point_double(acc)
        acc = point_add(acc, _table_lookup(qtab, d2[:, w]))
        acc = point_add(acc, _shared_table_lookup(gtab, d1[:, w]))
    return acc


def comb_add(acc, table, j: int, digit):
    """Window j of the comb: acc + digit * 2^(4j) * G, the table's affine
    entry added with Z = 1; rows whose digit is 0 keep acc (the kernel
    skips them, with no point at infinity to add)."""
    e = table[j, digit]
    t = point_add(acc, (e[:, 0], e[:, 1], F.one(digit.shape, digit.device)))
    keep = (digit == 0)[:, None]
    return tuple(torch.where(keep, a, b) for a, b in zip(acc, t))


def fixed_base_mul(k):
    """k*G by the doubling-free comb: 64 mixed additions of the table's
    v * 2^(4j) * G, one a window.  k: canonical limbs.  The JAX package
    adds (0:1:0) for a digit 0 where this keeps the sum, so the projective
    coordinates differ by a factor and the affine point is the same."""
    table = F._const("comb", _comb_table(), k)
    digits = digits4(k)
    acc = point_inf((k.shape[0],), k.device)
    for j in range(NDIGITS):
        acc = comb_add(acc, table, j, digits[:, j])
    return acc


# ---------------------------------------------------------------------------
# The square root, the parity flip and the inverses


def _pow2k(a, k: int):
    for _ in range(k):
        a = _sqr(a)
    return a


def sqrt_p(a):
    """a^((p+1)/4) mod p by the repunit addition chain: the exponent is
    [223 ones] 0 [22 ones] 0000 11 00; 253 squarings + 13 multiplies."""
    r1 = a
    r2 = _mul(_pow2k(r1, 1), r1)
    r4 = _mul(_pow2k(r2, 2), r2)
    r6 = _mul(_pow2k(r4, 2), r2)
    r8 = _mul(_pow2k(r4, 4), r4)
    r16 = _mul(_pow2k(r8, 8), r8)
    r22 = _mul(_pow2k(r16, 6), r6)
    r44 = _mul(_pow2k(r22, 22), r22)
    r88 = _mul(_pow2k(r44, 44), r44)
    r176 = _mul(_pow2k(r88, 88), r88)
    r220 = _mul(_pow2k(r176, 44), r44)
    r222 = _mul(_pow2k(r220, 2), r2)
    r223 = _mul(_pow2k(r222, 1), r1)
    acc = _pow2k(r223, 1)
    acc = _mul(_pow2k(acc, 22), r22)
    acc = _pow2k(acc, 4)
    acc = _mul(_pow2k(acc, 2), r2)
    return _pow2k(acc, 2)


def flip_parity(y, parity):
    """Negate y where its canonical parity differs from `parity`."""
    yn = F.normalize(FP, y)
    flip = (yn[..., 0] & 1) != parity.to(torch.int64)
    return F.select(flip, F.sub(FP, torch.zeros_like(y), y), y)


def decompress(qx, parity):
    """Canonical x and a y parity bit -> (y, on_curve): y = sqrt(x^3 + 7)
    with the requested parity, on_curve whether y^2 = x^3 + 7."""
    y2 = _add(_mul(_sqr(qx), qx), F.from_const(7, qx.shape[:-1], qx.device))
    y = sqrt_p(y2)
    return flip_parity(y, parity), F.eq(FP, _sqr(y), y2)


def inv_p(a):
    """a^(p-2) mod p by libsecp256k1's addition chain (blocks of 1, 2, 22
    and 223 ones): 255 squarings + 15 multiplies, the kernels' fp_inv
    op for op."""
    x2 = _mul(_pow2k(a, 1), a)
    x3 = _mul(_pow2k(x2, 1), a)
    x6 = _mul(_pow2k(x3, 3), x3)
    x9 = _mul(_pow2k(x6, 3), x3)
    x11 = _mul(_pow2k(x9, 2), x2)
    x22 = _mul(_pow2k(x11, 11), x11)
    x44 = _mul(_pow2k(x22, 22), x22)
    x88 = _mul(_pow2k(x44, 44), x44)
    x176 = _mul(_pow2k(x88, 88), x88)
    x220 = _mul(_pow2k(x176, 44), x44)
    x223 = _mul(_pow2k(x220, 3), x3)
    t = _mul(_pow2k(x223, 23), x22)
    t = _mul(_pow2k(t, 5), a)
    t = _mul(_pow2k(t, 3), x2)
    return _mul(_pow2k(t, 2), a)


_N_LOW128 = N_INT & ((1 << 128) - 1)


def inv_n(a):
    """a^(n-2) mod n (Fermat; 0 maps to 0).  n - 2 = (2^127 - 1) * 2^129
    + (low128 - 2): a repunit ladder gives the top 127 ones, a bit scan
    the low 129 bits; about 255 squarings + 81 multiplies."""
    def m(x, y):
        return F.mul(FN, x, y)

    def p2k(x, k):
        for _ in range(k):
            x = F.mul(FN, x, x)
        return x

    r1 = a
    r2 = m(p2k(r1, 1), r1)
    r3 = m(p2k(r2, 1), r1)
    r6 = m(p2k(r3, 3), r3)
    r7 = m(p2k(r6, 1), r1)
    r14 = m(p2k(r7, 7), r7)
    r15 = m(p2k(r14, 1), r1)
    r30 = m(p2k(r15, 15), r15)
    r31 = m(p2k(r30, 1), r1)
    r62 = m(p2k(r31, 31), r31)
    r63 = m(p2k(r62, 1), r1)
    r126 = m(p2k(r63, 63), r63)
    acc = m(p2k(r126, 1), r1)
    e_low = _N_LOW128 - 2
    run = 0
    for i in range(128, -1, -1):
        run += 1
        if (e_low >> i) & 1:
            acc = m(p2k(acc, run), r1)
            run = 0
    return p2k(acc, run)


# ---------------------------------------------------------------------------
# ECDSA


def host_verify_batch(msg_hashes: np.ndarray, sigs64: np.ndarray,
                      pubkeys33: np.ndarray) -> np.ndarray:
    """The exact-int host oracle with the kernel's semantics: bad pubkey
    tag, out-of-range r, high S and off-curve keys are all rejected."""
    out = np.zeros(msg_hashes.shape[0], bool)
    for i in range(msg_hashes.shape[0]):
        pk = bytes(pubkeys33[i])
        if pk[0] not in (2, 3):
            continue
        r = int.from_bytes(bytes(sigs64[i, :32]), "big")
        s = int.from_bytes(bytes(sigs64[i, 32:]), "big")
        if not (1 <= r < N_INT and 1 <= s <= (N_INT - 1) // 2):
            continue
        try:
            q = ref.pubkey_parse(pk)
        except ValueError:
            continue
        out[i] = ref.ecdsa_verify(bytes(msg_hashes[i]), r, s, q)
    return out


GRIND_CANDIDATES = 4
HALF_N = (N_INT - 1) // 2


def _low_r(r_norm):
    """low R: r < 2^255, bit 255 (bit 8 of limb 19) of canonical r clear."""
    return ((r_norm[..., NLIMBS - 1] >> (255 - 13 * 19)) & 1) == 0


def _sign_finish(z, d, r, k):
    """s = k^-1 (z + r d) mod n, low-S normalized, for canonical r, k < n
    and any 256-bit z; returns (s, s != 0)."""
    s = F.normalize(FN, F.mul(FN, F.inv_batch(FN, k),
                              F.add(FN, z, F.mul(FN, r, d))))
    s_ok = F.nonzero(s)
    high = ~F.lt_const(s, HALF_N + 1)
    neg = F.normalize(FN, F.sub(FN, torch.zeros_like(s), s))
    return F.select(high, neg, s), s_ok


def ecdsa_sign_kernel(z, d, ks):
    """Batched ECDSA sign with low-R grinding over C candidates.

    z: (B, 20) hash limbs (the raw 256-bit value); d: (B, 20) secret keys
    (< n); ks: (B, C, 20) canonical nonce candidates (host-made RFC6979
    stream).  Takes the first candidate whose r is low and nonzero, else
    candidate 0 (valid, high R); returns (r, s, ok, grind_ok)."""
    B, C, _ = ks.shape
    rx, _ = point_to_affine(fixed_base_mul(ks.reshape(B * C, NLIMBS)))
    r_all = F.normalize(FN, F.normalize(FP, rx)).reshape(B, C, NLIMBS)
    low = _low_r(r_all) & F.nonzero(r_all)
    choice = torch.argmax(low.to(torch.int64), dim=1)   # first True, else 0
    ar = torch.arange(B, device=z.device)
    r, k = r_all[ar, choice], ks[ar, choice]
    s, s_ok = _sign_finish(z, d, r, k)
    return r, s, F.nonzero(r) & s_ok, low.any(dim=1)


def ecdsa_sign_simple_kernel(z, d, k):
    """One nonce, no grinding: r = x(k*G) mod n, s = k^-1 (z + r d) mod n,
    low-S; returns (r, s, ok).  The bulk signer of the synthetic store."""
    rx, _ = point_to_affine(fixed_base_mul(k))
    r = F.normalize(FN, F.normalize(FP, rx))
    s, s_ok = _sign_finish(z, d, r, k)
    return r, s, F.nonzero(r) & s_ok


def derive_pubkeys_kernel(d):
    """d*G -> normalized affine (x, y) limbs."""
    x, y = point_to_affine(fixed_base_mul(d))
    return F.normalize(FP, x), F.normalize(FP, y)


def schnorr_verify_kernel(e, rx, s, px, dual_mul_fn):
    """Batched BIP340 verify for a precomputed challenge e (the raw
    256-bit tagged hash): R = s*G - e*P with P lifted to even y, valid if
    R is finite, has even y and x(R) = rx.  ``dual_mul_fn(u1, u2, qx,
    qy)`` computes u1*G + u2*Q (the engines' main-path scan)."""
    r_ok = F.lt_const(rx, P_INT)
    s_ok = F.lt_const(s, N_INT)
    p_ok = F.lt_const(px, P_INT)
    py, on_curve = decompress(px, torch.zeros(px.shape[:-1], dtype=torch.int64,
                                              device=px.device))
    e_n = F.normalize(FN, e)
    u = F.normalize(FN, F.sub(FN, torch.zeros_like(e_n), e_n))    # n - e
    R = dual_mul_fn(F.normalize(FN, s), u, px, py)
    not_inf = ~F.is_zero(FP, R[2])
    x_aff, y_aff = point_to_affine(R)
    even = (F.normalize(FP, y_aff)[..., 0] & 1) == 0
    return r_ok & s_ok & p_ok & on_curve & not_inf & even \
        & F.eq(FP, x_aff, rx)
