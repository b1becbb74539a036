"""256-bit modular arithmetic in PyTorch: the plain radix-2^13 engine.

A field element crosses every public function of the port as 20
little-endian limbs of 13 bits, shape ``(..., 20)``, exactly as in the
JAX package.  The limbs are stored in int64 (torch's uint32 coverage is
thin, on CUDA most of all); every value the engine produces is the same
uint32 value the JAX engine produces, op for op, so redundant
representatives agree limb for limb and not only after normalization.

The representation is redundant: stored limbs may exceed 13 bits
(invariant: each limb <= STORED_LIMB_MAX, value <= STORED_VMAX), carry
propagation after each op is one parallel shift-and-add, and the fold
count of each reduction comes from an exact interval analysis in Python
integers.  The analysis depends only on static bounds, so it runs once
per (modulus, input width, value bound, column bound) and is cached as a
plan of fold steps (``_reduce_plan``).

The CUDA kernels (``csrc/``) use their own representation, 8 limbs of 32
bits; ``to_u32x8`` / ``from_u32x8`` convert at the kernel boundary.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as nnf

LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1
NLIMBS = 20  # 260 bits >= 256
REPR_BITS = LIMB_BITS * NLIMBS  # 260
REPR_BOUND = 1 << REPR_BITS
STORED_LIMB_MAX = 40955

I64 = torch.int64


def _limbsum(bound: int, n: int) -> int:
    """Max value of n limbs each <= bound."""
    return bound * ((1 << (LIMB_BITS * n)) - 1) // LIMB_MASK


STORED_VMAX = _limbsum(STORED_LIMB_MAX, NLIMBS)


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    assert 0 <= x < (1 << (LIMB_BITS * n)), "value does not fit"
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)], dtype=np.int64)


def limbs_to_int(limbs) -> int:
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    limbs = np.asarray(limbs)
    return sum(int(v) << (LIMB_BITS * i)
               for i, v in enumerate(limbs.reshape(-1)))


class Modulus:
    """Static per-modulus constants, computed once with Python integers
    (the same derivation as the JAX package's field.Modulus)."""

    def __init__(self, m: int, name: str):
        assert (1 << 255) < m < (1 << 256), "modulus must be 256-bit"
        self.name = name
        self.m = m
        self.c260 = REPR_BOUND % m  # 2^260 = c260 (mod m)
        kc = max(1, (self.c260.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
        self.kc = kc
        self.c_limbs = int_to_limbs(self.c260, kc)
        self.m_limbs = int_to_limbs(m, NLIMBS)
        # borrow-safe decomposition of K*m with per-limb floor
        # STORED_LIMB_MAX, so neg - b >= 0 limb-wise for any stored b
        K = -(-STORED_VMAX // m)
        while True:
            Km = K * m
            nd = (Km.bit_length() + LIMB_BITS - 1) // LIMB_BITS
            d = [(Km >> (LIMB_BITS * k)) & LIMB_MASK for k in range(nd)]
            for k in range(NLIMBS):
                d[k] += 5 << LIMB_BITS
                d[k + 1] -= 5
            if (all(d[k] >= STORED_LIMB_MAX for k in range(NLIMBS))
                    and all(v >= 0 for v in d)
                    and all(v < (1 << 18) for v in d)):
                break
            K += 1
        assert sum(v << (LIMB_BITS * k) for k, v in enumerate(d)) == Km
        self.neg_limbs = np.array(d, dtype=np.int64)
        self.neg_bound = Km

    def __repr__(self):
        return f"Modulus({self.name})"


P_INT = 2**256 - 2**32 - 977
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
FP = Modulus(P_INT, "p")
FN = Modulus(N_INT, "n")
# Coordinates at the carry edges of p and of 8 x 32-bit words, canonical
# or not, for the kernels' edge checks.
P_EDGES = (0, 1, 2, P_INT - 1, P_INT - 2, P_INT, P_INT + 1, 2**32 - 1,
           2**64 - 1, 2**255, 2**256 - 2**32, 2**256 - 1)


_CONSTS: dict = {}


def _const(name: str, arr, like: torch.Tensor) -> torch.Tensor:
    """A host constant as an int64 tensor on like's device, copied there
    once per device."""
    key = (name, str(like.device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(np.asarray(arr, np.int64),
                                           device=like.device)
    return t


# ---------------------------------------------------------------------------
# Low-level limb helpers


def _pad_last(x: torch.Tensor, before: int, total: int) -> torch.Tensor:
    return nnf.pad(x, (before, total - before - x.shape[-1]))


def _carry_once(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """One parallel carry pass: limb' = (col & MASK) + (col[k-1] >> 13)."""
    lo = cols & LIMB_MASK
    hi = cols >> LIMB_BITS
    n = cols.shape[-1]
    total = max(out_limbs, n + 1)
    lo = _pad_last(lo, 0, total)
    hi = _pad_last(hi, 1, total)
    return (lo + hi)[..., :out_limbs]


def _skew_sum(m: torch.Tensor, shift: int, ncols: int) -> torch.Tensor:
    """cols[k] = sum over i of m[..., i, k - i - shift]: row i of the
    (..., na, nb) matrix moved right by i + shift, then summed."""
    na, nb = m.shape[-2], m.shape[-1]
    x = nnf.pad(m, (shift, ncols + 1 - nb - shift))        # (.., na, ncols+1)
    x = x.reshape(*m.shape[:-2], na * (ncols + 1))[..., :na * ncols]
    return x.reshape(*m.shape[:-2], na, ncols).sum(dim=-2)


def _mul_cols(a: torch.Tensor, b: torch.Tensor, na: int, nb: int):
    """Column sums of the schoolbook product, each 32-bit product split
    at bit 13 as the JAX engine splits it (so the columns are the same
    integers), NOT carried.  na + nb + 1 columns."""
    prod = a[..., :, None] * b[..., None, :]
    ncols = na + nb + 1
    return (_skew_sum(prod & LIMB_MASK, 0, ncols)
            + _skew_sum(prod >> LIMB_BITS, 1, ncols))


@functools.lru_cache(maxsize=None)
def _reduce_plan(mod_name: str, n_in: int, vmax: int, colmax: int):
    """The fold steps field._reduce takes for these static bounds, as a
    tuple: ("trunc", n) | ("merge",) | ("fold", hn, ncols, out_limbs).
    The interval analysis is the JAX package's, run once here."""
    mod = FP if mod_name == "p" else FN
    c = mod.c260
    lbound = LIMB_MASK + (colmax >> LIMB_BITS)
    n = n_in
    steps = []
    for _ in range(16):
        n_needed = max(
            NLIMBS, (max(vmax.bit_length(), 1) + LIMB_BITS - 1) // LIMB_BITS)
        if n > n_needed:
            steps.append(("trunc", n_needed))
            n = n_needed
        if n <= NLIMBS:
            assert lbound <= STORED_LIMB_MAX and vmax <= STORED_VMAX
            return tuple(steps)
        hn = n - NLIMBS
        hval = min(vmax >> REPR_BITS, _limbsum(lbound, hn))
        lval = min(vmax, _limbsum(lbound, NLIMBS))
        if hn == 1 and hval * LIMB_MASK + lbound <= STORED_LIMB_MAX:
            assert lval + hval * c <= STORED_VMAX
            steps.append(("merge",))
            return tuple(steps)
        ncols = max(NLIMBS, hn + mod.kc + 1)
        cnt = min(hn, mod.kc)
        prodmax = lbound * LIMB_MASK
        colmax2 = lbound + cnt * (LIMB_MASK + (prodmax >> LIMB_BITS))
        assert colmax2 < (1 << 32) - (1 << 19), "column overflow"
        new_vmax = lval + hval * c
        out_limbs = max(
            NLIMBS, (new_vmax.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
        assert new_vmax < vmax, "fold failed to make progress"
        steps.append(("fold", hn, ncols, out_limbs))
        n = out_limbs
        vmax = new_vmax
        lbound = LIMB_MASK + (colmax2 >> LIMB_BITS)
    raise AssertionError("reduce did not converge in 16 folds")


def _reduce(mod: Modulus, limbs: torch.Tensor, vmax: int, colmax: int):
    """Fold limbs down to the stored invariant (NLIMBS limbs, each <=
    STORED_LIMB_MAX, value <= STORED_VMAX, congruent mod m)."""
    plan = _reduce_plan(mod.name, limbs.shape[-1], vmax, colmax)
    for step in plan:
        if step[0] == "trunc":
            limbs = limbs[..., :step[1]]
        elif step[0] == "merge":
            h0 = limbs[..., NLIMBS:NLIMBS + 1]
            add_part = h0 * _const(mod.name + '.c', mod.c_limbs, limbs)
            limbs = limbs[..., :NLIMBS] + _pad_last(add_part, 0, NLIMBS)
        else:
            _, hn, ncols, out_limbs = step
            c_limbs = _const(mod.name + '.c', mod.c_limbs, limbs)
            hcols = _mul_cols(limbs[..., NLIMBS:], c_limbs,
                              hn, mod.kc)
            cols = (_pad_last(limbs[..., :NLIMBS], 0, ncols)
                    + _pad_last(hcols, 0, ncols))
            limbs = _carry_once(cols, out_limbs)
    return limbs


# ---------------------------------------------------------------------------
# Public modular ops.  Stored representatives: limbs <= STORED_LIMB_MAX.


def zero(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, NLIMBS), dtype=I64, device=device)


def one(shape=(), device="cpu") -> torch.Tensor:
    out = torch.zeros((*shape, NLIMBS), dtype=I64, device=device)
    out[..., 0] = 1
    return out


def from_const(x: int, shape=(), device="cpu") -> torch.Tensor:
    arr = torch.as_tensor(int_to_limbs(x % REPR_BOUND), device=device)
    return arr.expand(*shape, NLIMBS)


def add(mod: Modulus, a, b):
    limbs = _carry_once(a + b, NLIMBS + 1)
    return _reduce(mod, limbs, 2 * STORED_VMAX, 2 * STORED_LIMB_MAX)


def add3(mod: Modulus, a, b, c):
    limbs = _carry_once(a + b + c, NLIMBS + 1)
    return _reduce(mod, limbs, 3 * STORED_VMAX, 3 * STORED_LIMB_MAX)


def sub(mod: Modulus, a, b):
    neg = _const(mod.name + '.neg', mod.neg_limbs, a)
    nn = len(mod.neg_limbs)
    cols = neg - _pad_last(b, 0, nn) + _pad_last(a, 0, nn)
    colmax = (1 << 18) - 1 + STORED_LIMB_MAX
    limbs = _carry_once(cols, nn + 1)
    return _reduce(mod, limbs, mod.neg_bound + STORED_VMAX, colmax)


def mul(mod: Modulus, a, b):
    cols = _mul_cols(a, b, NLIMBS, NLIMBS)
    prodmax = STORED_LIMB_MAX * STORED_LIMB_MAX
    colmax = NLIMBS * (LIMB_MASK + (prodmax >> LIMB_BITS))
    limbs = _carry_once(cols, 2 * NLIMBS + 1)
    return _reduce(mod, limbs, STORED_VMAX * STORED_VMAX, colmax)


def sqr(mod: Modulus, a):
    return mul(mod, a, a)


def mul_small(mod: Modulus, a, k: int):
    """Multiply by a small constant k < 6144."""
    assert 0 <= k < 6144
    limbs = _carry_once(a * k, NLIMBS + 2)
    return _reduce(mod, limbs, STORED_VMAX * k, STORED_LIMB_MAX * k)


def _ripple(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Full sequential carry propagation to canonical limbs (< 2^13)."""
    out = []
    carry = torch.zeros_like(cols[..., 0])
    n = cols.shape[-1]
    for k in range(out_limbs):
        v = carry + cols[..., k] if k < n else carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out, dim=-1)


def normalize(mod: Modulus, a):
    """Map a redundant representative to canonical [0, m): exact ripple
    to 22 limbs, fold the top limbs back via 2^260 = c260 (mod m), then
    conditional subtracts of 16m, 8m, 4m, 2m, m."""
    x = _ripple(a, NLIMBS + 2)
    lo = x[..., :NLIMBS]
    hi = x[..., NLIMBS:]
    cols = _pad_last(lo, 0, NLIMBS + 1)
    c_limbs = _const(mod.name + '.c', mod.c_limbs, a)
    for j in range(2):
        cols = cols + _pad_last(hi[..., j:j + 1] * c_limbs, j, NLIMBS + 1)
    x = _ripple(cols, NLIMBS + 1)
    W = NLIMBS + 1
    for k in (16, 8, 4, 2, 1):
        km = int_to_limbs(k * mod.m, W + 1)
        xi = _pad_last(x, 0, W + 1)
        outs = []
        carry = torch.zeros_like(xi[..., 0])
        for i in range(W + 1):
            v = xi[..., i] - int(km[i]) + carry
            outs.append(v & LIMB_MASK)
            carry = v >> LIMB_BITS  # arithmetic shift: -1 on borrow
        t = torch.stack(outs, dim=-1)[..., :W]
        x = torch.where((carry == 0)[..., None], t, x)
    return x[..., :NLIMBS]


def is_zero(mod: Modulus, a):
    return torch.all(normalize(mod, a) == 0, dim=-1)


def eq(mod: Modulus, a, b):
    return torch.all(normalize(mod, a) == normalize(mod, b), dim=-1)


def select(cond, a, b):
    """cond: bool (...,); a, b: (..., NLIMBS)."""
    return torch.where(cond[..., None], a, b)


def pow_const(mod: Modulus, a, e: int):
    """a^e for a static exponent e >= 1: square-and-multiply over its
    bits, most significant first."""
    assert e >= 1
    acc = a
    for i in range(e.bit_length() - 2, -1, -1):
        acc = mul(mod, acc, acc)
        if (e >> i) & 1:
            acc = mul(mod, acc, a)
    return acc


def inv(mod: Modulus, a):
    """Fermat inversion a^(m-2) by 256 square-and-multiply steps from 1
    (so inv(0) = 0)."""
    acc = one(a.shape[:-1], a.device)
    e = mod.m - 2
    for i in range(255, -1, -1):
        acc = mul(mod, acc, acc)
        if (e >> i) & 1:
            acc = mul(mod, acc, a)
    return acc


def _scan_products(mod: Modulus, a, reverse: bool = False):
    """Inclusive products along axis 0 (suffix products if reverse) by
    Hillis-Steele doubling: ceil(log2 B) batched multiplications."""
    x = a.flip(0) if reverse else a
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], mul(mod, x[d:], x[:-d])])
        d *= 2
    return x.flip(0) if reverse else x


def inv_batch(mod: Modulus, a):
    """Batched inversion by Montgomery's trick: prefix and suffix product
    sweeps and ONE Fermat inversion of the total, then
    inv(a_i) = prefix_{i-1} * suffix_{i+1} * inv(total).  Zero inputs
    count as 1 in the sweeps and give 0 (the inv(0) = 0 convention).
    a: (B, NLIMBS); any other rank takes the per-element Fermat chain."""
    if a.ndim != 2:
        return inv(mod, a)
    z = is_zero(mod, a)
    a1 = select(z, one(a.shape[:-1], a.device), a)
    pre = _scan_products(mod, a1)
    suf = _scan_products(mod, a1, reverse=True)
    total_inv = inv(mod, pre[-1:])
    one_row = one((1,), a.device)
    before = torch.cat([one_row, pre[:-1]])
    after = torch.cat([suf[1:], one_row])
    out = mul(mod, mul(mod, before, after), total_inv.expand_as(a))
    return select(z, torch.zeros_like(a), out)


def odd(a):
    """Parity of a canonical (normalized) value."""
    return (a[..., 0] & 1) != 0


def nonzero(a):
    return torch.any(a != 0, dim=-1)


def canonical_bits(a, nbits: int = 256):
    """Canonical limbs -> (..., nbits) bit tensor, LSB first."""
    shifts = torch.arange(LIMB_BITS, dtype=I64, device=a.device)
    bits = (a[..., :, None] >> shifts) & 1
    return bits.reshape(*a.shape[:-1], NLIMBS * LIMB_BITS)[..., :nbits]


def lt_const(a, c: int):
    """a < c for canonical-limb a and a static 260-bit constant."""
    climbs = int_to_limbs(c, NLIMBS)
    carry = torch.zeros_like(a[..., 0])
    for k in range(NLIMBS):
        v = a[..., k] - int(climbs[k]) + carry
        carry = v >> LIMB_BITS
    return carry < 0


def from_bytes_be_dev(data: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 big-endian tensor -> (..., 20) canonical limbs,
    on data's device.  Each 13-bit limb spans at most 3 bytes."""
    d = data.to(I64)
    limbs = []
    for j in range(NLIMBS):
        k0, r = divmod(j * LIMB_BITS, 8)
        v = torch.zeros_like(d[..., 0])
        for t in range(3):
            k = k0 + t
            if k < 32:
                v = v | (d[..., 31 - k] << (8 * t))
        limbs.append((v >> r) & LIMB_MASK)
    return torch.stack(limbs, dim=-1)


def from_bytes_be(data: np.ndarray) -> torch.Tensor:
    """Host (..., 32) uint8 array -> (..., 20) int64 canonical limbs."""
    return from_bytes_be_dev(torch.from_numpy(
        np.ascontiguousarray(data, dtype=np.uint8)))


def to_bytes_be(limbs) -> np.ndarray:
    """(..., 20) canonical limbs -> host (..., 32) uint8 big-endian."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    limbs = np.asarray(limbs, dtype=np.int64)
    shifts = np.arange(LIMB_BITS, dtype=np.int64)
    bits = ((limbs[..., :, None] >> shifts) & 1).astype(np.uint8)
    bits = bits.reshape(*limbs.shape[:-1], REPR_BITS)[..., :256]
    return np.packbits(bits[..., ::-1], axis=-1, bitorder="big")


def from_int_array(xs, device="cpu") -> torch.Tensor:
    """Python ints -> (B, 20) int64 limbs."""
    xs = list(xs)
    out = np.zeros((len(xs), NLIMBS), dtype=np.int64)
    for i, x in enumerate(xs):
        out[i] = int_to_limbs(x % REPR_BOUND)
    return torch.as_tensor(out, device=device)


def to_int_list(limbs) -> list[int]:
    """(B, 20) limbs (any representative) -> Python ints of their value."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    return [limbs_to_int(row) for row in np.asarray(limbs)]


# ---------------------------------------------------------------------------
# The kernels' representation: 8 little-endian 32-bit words, stored as
# int32 (the bits of the uint32 word), limbs first: (8, B).


def to_u32x8(a: torch.Tensor) -> torch.Tensor:
    """(B, 20) canonical radix-13 limbs -> (8, B) int32 words."""
    return torch.stack(_u32_words(a), dim=0).to(torch.int32).contiguous()


def to_u32_rows(a: torch.Tensor) -> torch.Tensor:
    """(B, 20) canonical radix-13 limbs -> (B, 8) int32 words, each
    element's 8 words contiguous."""
    return torch.stack(_u32_words(a), dim=-1).to(torch.int32)


def _u32_words(a: torch.Tensor) -> list[torch.Tensor]:
    """The 8 little-endian 32-bit words of canonical limbs (..., 20), each
    (...,) int64 in the int32 range."""
    words = []
    for k in range(8):
        w = torch.zeros_like(a[..., 0])
        for j in range(NLIMBS):
            sh = LIMB_BITS * j - 32 * k
            if -LIMB_BITS < sh < 32:
                part = a[..., j] << sh if sh >= 0 else a[..., j] >> -sh
                w = w | part
        w = w & 0xFFFFFFFF
        words.append(torch.where(w >= (1 << 31), w - (1 << 32), w))
    return words


def from_u32x8(w: torch.Tensor) -> torch.Tensor:
    """(8, B) int32 words -> (B, 20) canonical radix-13 int64 limbs."""
    w = w.to(I64) & 0xFFFFFFFF
    limbs = []
    for j in range(NLIMBS):
        k0, r = divmod(LIMB_BITS * j, 32)
        v = w[k0] >> r
        if r + LIMB_BITS > 32 and k0 + 1 < 8:
            v = v | (w[k0 + 1] << (32 - r))
        limbs.append(v & LIMB_MASK)
    return torch.stack(limbs, dim=-1)


def words_from_be_bytes(data: np.ndarray, device="cpu") -> torch.Tensor:
    """Host (B, 32) uint8 big-endian values -> (8, B) int32 kernel words
    (any 256-bit value, reduced by no modulus)."""
    le = np.ascontiguousarray(np.asarray(data, np.uint8)[:, ::-1])
    return torch.from_numpy(np.ascontiguousarray(le.view("<i4").T)) \
        .to(device)


def words_to_be_bytes(w: torch.Tensor) -> np.ndarray:
    """(8, B) int32 kernel words -> host (B, 32) uint8 big-endian."""
    le = np.ascontiguousarray(w.cpu().numpy().T.astype("<i4"))
    return np.ascontiguousarray(le.view(np.uint8)[:, ::-1])


def ints_to_be_bytes(xs) -> np.ndarray:
    """Python ints in [0, 2^256) -> host (B, 32) uint8 big-endian."""
    raw = bytearray(b"".join(x.to_bytes(32, "big") for x in xs))
    return np.frombuffer(raw, np.uint8).reshape(-1, 32)
