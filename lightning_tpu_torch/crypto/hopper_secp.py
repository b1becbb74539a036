"""The port's eight hand-written CUDA kernels: wrappers, plain versions
and launch counters.  K1-K6 are the verify engines' (each replaces a
pallas_call), S1 and S2 the sign path's (each replaces an XLA program).

Each kernel has, beside its wrapper:

* a plain PyTorch version of the same function, in the radix-2^13 engine
  of ``field.py``, op for op;
* a launch counter, the plain integer ``<wrapper>.launches``, which the
  wrapper raises by one where it launches the kernel and nowhere else.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises: there is no fallback.

| kernel | wrapper | replaces (lightning_tpu/crypto/pallas_secp.py) |
| --- | --- | --- |
| K1 csrc/verify_prep.cu | ``verify_prep_core`` | ``_verify_prep_kernel``, pallas_call :322 |
| K2 csrc/build_tables.cu | ``build_tables`` | ``_build_tables_kernel``, pallas_call :735 |
| K3 csrc/glv_scan.cu | ``glv_scan`` | ``_make_glv_kernel(1)``, pallas_call :627 |
| K4 csrc/glv_scan2.cu | ``glv_scan2`` | ``_make_glv_kernel(2)``, pallas_call :627 |
| K5 csrc/dual_mul_v2.cu | ``dual_mul_v2`` | ``_dual_mul_kernel_v2``, pallas_call :462 |
| K6 csrc/dual_mul_planes.cu | ``dual_mul_planes`` | ``_dual_mul_kernel``, pallas_call :807 |

| kernel | wrapper | replaces (lightning_tpu/crypto/secp256k1.py, XLA) |
| --- | --- | --- |
| S1 csrc/fixed_base.cu | ``fixed_base_affine`` | ``derive_pubkeys_kernel`` :451 |
| S2 csrc/ecdsa_sign.cu | ``ecdsa_sign`` | ``ecdsa_sign_kernel`` :405 (C = 4), ``ecdsa_sign_simple_kernel`` :437 (C = 1) |

All eight are bound by 32-bit integer multiplies: ``field_op_counts``
counts the field operations of each plain version, less its products by
a constant Z = 1 (K2's base, the comb's entries: the kernels repeat the
rest op for op) and ``PRODUCTS`` holds the fewest 32-bit products each
needs; their bound is computed from the two.  The kernels
keep field elements as 8 x 32-bit words (``field.to_u32x8``), limbs first
with the batch fastest; the conversion from and to radix-2^13 limbs is
plain torch in the wrappers.  K4-K6 take their points as word planes,
(n, 3, 8, B) int32: entry, coordinate, word, signature; K5 takes its
per-key table signature-major, (B, 16, 3, 8).  Which operands are
selected in the kernel and which outside is what tells the engines apart
(``engines.py``), so each kernel keeps its TPU twin's contract.  S1 and S2
take and return (8, B) words (``field.words_from_be_bytes`` makes them
from bytes on the host), and read the comb table of v * 2^(4j) * G as
(64, 15, 2, 8) words; their work depends on the data (the nonzero digits
of each scalar, and for S2 the candidates tried), which
``comb_op_counts`` counts.  Both invert by Montgomery's trick, one Fermat
chain a block, as K1 does; S2 signs a tile of rows a block in candidate
rounds, each computing k*G only for the rows still pending, packed onto
the low threads, with idle threads taking pending rows' later
candidates; both run one block of 512 threads an SM, the grid sized from
the occupancy query and the rows spread over it; S1 reads the comb table
from a copy in shared memory (csrc/ecdsa_sign.cu, csrc/fixed_base.cu).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import field as F
from . import glv as GLV
from . import secp256k1 as S
from .field import FN, FP, NLIMBS

# The fewest 32x32 -> 64-bit products each field operation needs in the
# kernels' 8 x 32-bit representation: a multiplication mod p is the 8x8
# schoolbook (64) plus the fold by 977 (9); a squaring needs 36 of the 64
# (8 squares, 28 doubled cross products) plus the fold; a Montgomery
# multiplication mod n is 64 + 64 for the reduction + 8 for its quotient
# digits, a squaring 36 + 64 + 8; a small multiple is 8 plus its fold.
PRODUCTS = {"mul_p": 73, "sqr_p": 45, "mul_n": 136, "sqr_n": 108,
            "mul_small_p": 9}

# K1, S1 and S2 invert by Montgomery's trick, one Fermat chain a block
# (block_inv and K1's scan in csrc/secp256k1.cuh).  Their bound counts the
# trick's fewest products: per value BATCH_MUL_VALUE (its prefix product,
# its inverse from the prefix before it and the running inverse, the
# running inverse times it), one more mod n to enter the Montgomery
# domain; per block the chain, one more mod n to leave the domain.  The
# kernels take 12 a value (5 + 5 warp scan steps, the product of the
# warp's other lanes, the output) and 3 a warp around the chain: that is
# the design's overhead, not in the bound.  K1's block is PREP_THREADS
# signatures (csrc/verify_prep.cu), S1's and S2's SIGN_THREADS threads
# (csrc/fixed_base.cu S1_THREADS, csrc/ecdsa_sign.cu S2_THREADS;
# tests/test_torch_kernels.py holds the three equal).  The sign kernels'
# bound counts full blocks: the fewest products.
PREP_THREADS = 256
SIGN_THREADS = 512
BATCH_MUL_VALUE = 3


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=None)
def _kernel(name: str, entry: str, n_ptr: int):
    return _build.c_launch(_build.lib(name), entry, n_ptr, 1)


def _launch(name: str, *tensors: torch.Tensor, B: int,
            entry: str | None = None) -> None:
    """Launch ``<entry>_launch`` (by default ``<name>_launch``) of kernel
    library `name` on the current stream; operands are contiguous int32
    CUDA tensors (uint8 for byte flags)."""
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous()
                and t.dtype in (torch.int32, torch.uint8)):
            raise ValueError(f"{name}: operands must be contiguous int32 "
                             "(or uint8 flag) CUDA tensors")
    rc = _kernel(name, entry or name, len(tensors))(*map(_ptr, tensors), B,
                                                    _stream())
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _u32x8(a: torch.Tensor) -> torch.Tensor:
    """Any representative mod p -> canonical (8, B) kernel words."""
    return F.to_u32x8(F.normalize(FP, a))


# ---------------------------------------------------------------------------
# Operand helpers; K4-K6 take points as word planes


def to_words(a: torch.Tensor) -> torch.Tensor:
    """Limbs (..., 20), any representative mod p -> canonical kernel
    words (..., 8) int32, contiguous."""
    rows = F.to_u32_rows(F.normalize(FP, a.reshape(-1, NLIMBS)))
    return rows.reshape(*a.shape[:-1], 8)


def _plane_point(planes: torch.Tensor, j: int):
    """Entry j of (n, 3, 8, B) word planes -> a point of (B, 20) limbs."""
    return tuple(F.from_u32x8(planes[j, c]) for c in range(3))


def _expect(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: operand of shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _scan_out(B: int, device, n: int = 3) -> list[torch.Tensor]:
    return [torch.empty((8, B), dtype=torch.int32, device=device)
            for _ in range(n)]


def _i32(*ts: torch.Tensor) -> list[torch.Tensor]:
    return [t.to(torch.int32).contiguous() for t in ts]


# ---------------------------------------------------------------------------
# K1: verify prep


def verify_prep_plain(qx, s):
    """Plain version of K1: y = sqrt(x^3 + 7), d = y^2 - (x^3 + 7) (mod p),
    w = s^-1 (mod n), as radix-2^13 representatives."""
    x3 = S._mul(S._sqr(qx), qx)
    y2 = S._add(x3, F.from_const(7, qx.shape[:-1], qx.device))
    y = S.sqrt_p(y2)
    d = S._sub(S._sqr(y), y2)
    return y, d, S.inv_n(s)


def verify_prep_core(qx, s):
    """K1 wrapper.  qx, s: (B, 20) limbs.  Returns (y, d, w) as (B, 20)
    limbs."""
    if not _on_card(qx):
        return verify_prep_plain(qx, s)
    B = qx.shape[0]
    x8, s8 = _u32x8(qx), F.to_u32x8(F.normalize(FN, s))
    y8, d8, w8 = (torch.empty_like(x8) for _ in range(3))
    _launch("verify_prep", x8, s8, y8, d8, w8, B=B)
    verify_prep_core.launches += 1
    return F.from_u32x8(y8), F.from_u32x8(d8), F.from_u32x8(w8)


verify_prep_core.launches = 0


def verify_prep(qx, parity, s):
    """(decompress, s^-1) stage of ``ecdsa_verify_kernel`` through K1:
    returns (qy with the requested parity, on_curve, w)."""
    y, d, w = verify_prep_core(qx, s)
    return S.flip_parity(y, parity), F.is_zero(FP, d), w


# ---------------------------------------------------------------------------
# K2: per-key window tables


def build_tables_plain(bx, byl, sflip):
    """Plain version of K2.  lo[v] = v*(bx, byl) for v = 0..15, entry 0
    = (0:1:0); hi[v] = (beta*X_v, +-Y_v, Z_v), Y negated where sflip.
    Returns (lo, hi), each a tuple of three (16, B, 20) coordinates."""
    B = bx.shape[0]
    zero, one = F.zero((B,), bx.device), F.one((B,), bx.device)
    beta = GLV._const(GLV.BETA, bx)
    keep = (sflip == 0)[:, None]
    lo, hi = [(zero, one, zero)], [(zero, one, zero)]
    base = (bx, byl, one)
    acc = base
    for v in range(1, 16):
        if v > 1:
            acc = S.point_add(acc, base)
        ax, ay, az = acc
        lo.append(acc)
        ay_neg = F.sub(FP, zero, ay)
        hi.append((F.mul(FP, ax, beta), torch.where(keep, ay, ay_neg), az))

    def planes(entries):
        return tuple(torch.stack([e[c] for e in entries]) for c in range(3))

    return planes(lo), planes(hi)


def build_tables(bx, byl, sflip):
    """K2 wrapper.  bx, byl: (B, 20) limbs; sflip: (B,) 0/1.  On the CPU
    returns the plain version's (lo, hi); on the card the kernel's
    (6, 16, 8, B) int32 table block (``tables_to_limbs`` converts it)."""
    if not _on_card(bx):
        return build_tables_plain(bx, byl, sflip)
    B = bx.shape[0]
    out = torch.empty((6, 16, 8, B), dtype=torch.int32, device=bx.device)
    _launch("build_tables", _u32x8(bx), _u32x8(byl),
            sflip.to(torch.int32).contiguous(), out, B=B)
    build_tables.launches += 1
    return out


build_tables.launches = 0


def tables_to_limbs(tab: torch.Tensor):
    """Kernel table block (6, 16, 8, B) -> the plain layout (lo, hi)."""
    B = tab.shape[-1]
    coords = [F.from_u32x8(tab[c].permute(1, 0, 2).reshape(8, 16 * B))
              .reshape(16, B, NLIMBS) for c in range(6)]
    return tuple(coords[:3]), tuple(coords[3:])


def tables_to_words(lo, hi) -> torch.Tensor:
    """The plain layout (lo, hi), each three (16, B, 20) limb tensors,
    -> the kernel's (6, 16, 8, B) table block (the inverse of
    ``tables_to_limbs``)."""
    return torch.stack([to_words(c) for c in (*lo, *hi)]) \
        .permute(0, 1, 3, 2).contiguous()


def as_tables(lo, hi):
    """Per-key tables in the plain layout -> what ``build_tables``
    returns on their device: (lo, hi) itself on the CPU, the word block
    on the card."""
    return tables_to_words(lo, hi) if _on_card(lo[0]) else (lo, hi)


# ---------------------------------------------------------------------------
# K3: the 33-window GLV scan


def _joint_table(device) -> torch.Tensor:
    """The (1024, 3, 20) joint G / phi(G) table on `device`."""
    return F._const("glv.joint", GLV._g_joint_window_proj(),
                    torch.empty(0, device=device))


@functools.lru_cache(maxsize=None)
def _joint_table_u32(device: str) -> torch.Tensor:
    """The joint table in kernel words: (1024, 3, 8) int32, 96 KB."""
    jt = _joint_table(device).reshape(1024 * 3, NLIMBS)
    return F.to_u32x8(jt).T.reshape(1024, 3, 8).contiguous()


def glv_scan_plain(d2l, d2h, gidx, lo, hi):
    """Plain version of K3: 33 windows of acc = 16 acc + lo[d2l] +
    hi[d2h] + joint[gidx] from infinity.  Digits and joint indices are
    (33, B), most significant window first."""
    B = d2l.shape[1]
    jt = _joint_table(d2l.device)
    ar = torch.arange(B, device=d2l.device)
    acc = S.point_inf((B,), d2l.device)
    for w in range(d2l.shape[0]):
        for _ in range(S.WINDOW):
            acc = S.point_double(acc)
        acc = S.point_add(acc, tuple(c[d2l[w], ar] for c in lo))
        acc = S.point_add(acc, tuple(c[d2h[w], ar] for c in hi))
        g = jt[gidx[w]]
        acc = S.point_add(acc, (g[:, 0], g[:, 1], g[:, 2]))
    return acc


def glv_scan(d2l, d2h, gidx, tables):
    """K3 wrapper: projective u1*G + u2*Q as three (B, 20) limb tensors.
    ``tables`` is what ``build_tables`` returned on the same device."""
    if not _on_card(d2l):
        return glv_scan_plain(d2l, d2h, gidx, *tables)
    B = d2l.shape[1]
    for t in (d2l, d2h, gidx):
        _expect("glv_scan", t, (GLV.NDIGITS_GLV, B))
    _expect("glv_scan", tables, (6, 16, 8, B))
    jt = _joint_table_u32(str(d2l.device))
    out = _scan_out(B, d2l.device)
    _launch("glv_scan", *_i32(d2l, d2h, gidx), tables, jt, *out, B=B)
    glv_scan.launches += 1
    return tuple(F.from_u32x8(o) for o in out)


glv_scan.launches = 0


# ---------------------------------------------------------------------------
# K4: the 33-window GLV scan with separate G and phi(G) additions


def glv_scan2_plain(d2l, d2h, lo, hi, g1, g2):
    """Plain version of K4: 33 windows of acc = 16 acc + lo[d2l] +
    hi[d2h] + g1[w] + g2[w] from infinity.  Digits are (33, B), most
    significant window first; g1, g2 are the pre-selected, pre-signed G
    and phi(G) points as (33, 3, 8, B) word planes."""
    B = d2l.shape[1]
    ar = torch.arange(B, device=d2l.device)
    acc = S.point_inf((B,), d2l.device)
    for w in range(d2l.shape[0]):
        for _ in range(S.WINDOW):
            acc = S.point_double(acc)
        acc = S.point_add(acc, tuple(c[d2l[w], ar] for c in lo))
        acc = S.point_add(acc, tuple(c[d2h[w], ar] for c in hi))
        acc = S.point_add(acc, _plane_point(g1, w))
        acc = S.point_add(acc, _plane_point(g2, w))
    return acc


def glv_scan2(d2l, d2h, tables, g1, g2):
    """K4 wrapper: projective point as three (B, 20) limb tensors.
    ``tables`` is a per-key table block in ``build_tables``'s layout for
    the device (``as_tables`` makes one from limbs); g1, g2: (33, 3, 8, B)
    int32 word planes."""
    if not _on_card(d2l):
        return glv_scan2_plain(d2l, d2h, *tables, g1, g2)
    B = d2l.shape[1]
    for t in (d2l, d2h):
        _expect("glv_scan2", t, (GLV.NDIGITS_GLV, B))
    _expect("glv_scan2", tables, (6, 16, 8, B))
    for g in (g1, g2):
        _expect("glv_scan2", g, (GLV.NDIGITS_GLV, 3, 8, B))
    out = _scan_out(B, d2l.device)
    _launch("glv_scan2", *_i32(d2l, d2h), tables, g1, g2, *out, B=B)
    glv_scan2.launches += 1
    return tuple(F.from_u32x8(o) for o in out)


glv_scan2.launches = 0


# ---------------------------------------------------------------------------
# K5: the 64-window scan, Q table selected in the kernel


def dual_mul_v2_plain(d2, qtab, gs):
    """Plain version of K5: 64 windows of acc = 16 acc + qtab[d2[w]] +
    gs[w] from infinity.  d2: (64, B) digits of u2, most significant
    first; qtab: the per-key table v*Q as (B, 16, 3, 8) words; gs:
    (64, 3, 8, B) word planes of the pre-selected G points."""
    B = d2.shape[1]
    ar = torch.arange(B, device=d2.device)
    tab = [torch.stack([F.from_u32x8(qtab[:, v, c].T) for v in range(16)])
           for c in range(3)]
    acc = S.point_inf((B,), d2.device)
    for w in range(d2.shape[0]):
        for _ in range(S.WINDOW):
            acc = S.point_double(acc)
        acc = S.point_add(acc, tuple(c[d2[w], ar] for c in tab))
        acc = S.point_add(acc, _plane_point(gs, w))
    return acc


def dual_mul_v2(d2, qtab, gs):
    """K5 wrapper: projective point as three (B, 20) limb tensors.  qtab
    is signature-major, (B, 16, 3, 8) int32 (``to_words`` of the
    (B, 16, 3, 20) window table), 16-byte aligned on the card: the kernel
    copies an entry in 16-byte pieces."""
    if not _on_card(d2):
        return dual_mul_v2_plain(d2, qtab, gs)
    B = d2.shape[1]
    _expect("dual_mul_v2", d2, (S.NDIGITS, B))
    _expect("dual_mul_v2", qtab, (B, 16, 3, 8))
    _expect("dual_mul_v2", gs, (S.NDIGITS, 3, 8, B))
    if qtab.data_ptr() % 16:
        raise ValueError("dual_mul_v2: the table must be 16-byte aligned")
    out = _scan_out(B, d2.device)
    _launch("dual_mul_v2", *_i32(d2), qtab, gs, *out, B=B)
    dual_mul_v2.launches += 1
    return tuple(F.from_u32x8(o) for o in out)


dual_mul_v2.launches = 0


# ---------------------------------------------------------------------------
# K6: the 64-window scan over pre-selected Q and G planes


def dual_mul_planes_plain(qs, gs):
    """Plain version of K6: 64 windows of acc = 16 acc + qs[w] + gs[w]
    from infinity; qs, gs: (64, 3, 8, B) word planes of the pre-selected
    Q and G points."""
    B = qs.shape[-1]
    acc = S.point_inf((B,), qs.device)
    for w in range(qs.shape[0]):
        for _ in range(S.WINDOW):
            acc = S.point_double(acc)
        acc = S.point_add(acc, _plane_point(qs, w))
        acc = S.point_add(acc, _plane_point(gs, w))
    return acc


def dual_mul_planes(qs, gs):
    """K6 wrapper: projective point as three (B, 20) limb tensors."""
    if not _on_card(qs):
        return dual_mul_planes_plain(qs, gs)
    B = qs.shape[-1]
    for t in (qs, gs):
        _expect("dual_mul_planes", t, (S.NDIGITS, 3, 8, B))
    out = _scan_out(B, qs.device)
    _launch("dual_mul_planes", qs, gs, *out, B=B)
    dual_mul_planes.launches += 1
    return tuple(F.from_u32x8(o) for o in out)


dual_mul_planes.launches = 0


# ---------------------------------------------------------------------------
# S1 and S2: k*G by the comb, and ECDSA signing


@functools.lru_cache(maxsize=None)
def _comb_words(device: str) -> torch.Tensor:
    """The comb table v * 2^(4j) * G, v = 1..15, as (64, 15, 2, 8) int32
    words (61,440 bytes)."""
    tab = torch.as_tensor(S._comb_table()[:, 1:])            # (64, 15, 2, 20)
    return F.to_u32_rows(tab.reshape(-1, NLIMBS)).reshape(64, 15, 2, 8) \
        .contiguous().to(device)


def fixed_base_affine_plain(k):
    """Plain version of S1: ``derive_pubkeys_kernel`` (point_to_affine of
    the comb, normalized) on words.  k: (8, B) words -> (x, y) words."""
    return tuple(map(F.to_u32x8, S.derive_pubkeys_kernel(F.from_u32x8(k))))


def fixed_base_affine(k):
    """S1 wrapper: k*G for (8, B) int32 scalar words; returns normalized
    affine (x, y) as (8, B) words, (0, 0) for infinity."""
    if not _on_card(k):
        return fixed_base_affine_plain(k)
    B = k.shape[-1]
    _expect("fixed_base_affine", k, (8, B))
    x, y = _scan_out(B, k.device, 2)
    _launch("fixed_base", k.to(torch.int32).contiguous(),
            _comb_words(str(k.device)), x, y, B=B)
    fixed_base_affine.launches += 1
    return x, y


fixed_base_affine.launches = 0


def ecdsa_sign_plain(z, d, ks):
    """Plain version of S2: ``ecdsa_sign_kernel`` (C > 1) or
    ``ecdsa_sign_simple_kernel`` (C = 1) on words.  z, d: (8, B); ks:
    (C, 8, B).  Returns (r, s) words and (ok, grind) bool (B,)."""
    zl, dl = F.from_u32x8(z), F.from_u32x8(d)
    if ks.shape[0] == 1:
        r, s, ok = S.ecdsa_sign_simple_kernel(zl, dl, F.from_u32x8(ks[0]))
        grind = S._low_r(r) & F.nonzero(r)
    else:
        kl = torch.stack([F.from_u32x8(kc) for kc in ks], dim=1)
        r, s, ok, grind = S.ecdsa_sign_kernel(zl, dl, kl)
    return F.to_u32x8(r), F.to_u32x8(s), ok, grind


SIGN_CANDIDATES = (1, 4)    # the C the kernel is built for


def ecdsa_sign(z, d, ks):
    """S2 wrapper: ECDSA signatures of hashes z by keys d with C nonce
    candidates ks, all int32 words: z, d (8, B), ks (C, 8, B), C = 1 or 4.
    Returns r, s as (8, B) words (s low-S) and ok, grind as bool (B,)."""
    if not _on_card(z):
        return ecdsa_sign_plain(z, d, ks)
    C, B = ks.shape[0], z.shape[-1]
    if C not in SIGN_CANDIDATES:
        raise ValueError(f"ecdsa_sign: {C} candidates, the kernel takes "
                         f"{SIGN_CANDIDATES}")
    for t, shape in ((z, (8, B)), (d, (8, B)), (ks, (C, 8, B))):
        _expect("ecdsa_sign", t, shape)
    r, s = _scan_out(B, z.device, 2)
    ok, grind = (torch.empty(B, dtype=torch.uint8, device=z.device)
                 for _ in range(2))
    _launch("ecdsa_sign", *_i32(z, d, ks), _comb_words(str(z.device)), r, s,
            ok, grind, B=B, entry=f"ecdsa_sign{C}")
    ecdsa_sign.launches += 1
    return r, s, ok.bool(), grind.bool()


ecdsa_sign.launches = 0


KERNELS = (verify_prep_core, build_tables, glv_scan, glv_scan2, dual_mul_v2,
           dual_mul_planes, fixed_base_affine, ecdsa_sign)


def _batch_inversion_counts(chain: dict, kind: str, threads: int,
                            domain: int) -> dict[str, float]:
    """Field operations a value of a batch inversion over blocks of
    `threads`: BATCH_MUL_VALUE products of `kind` (plus `domain`, 1 mod n
    for entering the Montgomery domain), and 1/threads of the block's
    Fermat chain `chain` (plus `domain` for leaving it)."""
    block = dict(chain)
    block[kind] = block.get(kind, 0) + domain
    out = {k: v / threads for k, v in block.items()}
    out[kind] += BATCH_MUL_VALUE + domain
    return out


def field_op_counts() -> dict[str, dict[str, float]]:
    """Field operations per signature of each kernel, by kind (mul_p,
    sqr_p, mul_n, sqr_n, mul_small_p): its plain version run on one CPU
    signature with F.mul and F.mul_small counted; a product of a tensor
    with itself counts as a squaring.  K2's base and the comb's entries
    have the constant Z = 1, which the kernels add by ``pt_add_z1``: a
    product by that one is not work the function needs, and is not
    counted.  The window scans run one window and count it once per
    window of the kernel (every window does the same operations).  K1's
    entry counts the kernel's batch inversion (its plain version's count
    less the chain inv_n, plus ``_batch_inversion_counts`` of it);
    "verify_prep_chain_per_signature" is its plain version's count, a
    Fermat chain per signature, the design K1 had before.  S1's and S2's
    work depends on the data: "comb_add" (one window of the comb), and a
    value's inversion, "inv_p_batch" and "inv_n_batch" by a block's batch
    inversion as the kernels invert, "inv_p" and "inv_n" by a Fermat chain
    of its own, are the units ``comb_op_counts`` adds up."""
    counts: dict[str, int] = {}
    real_mul, real_small, real_one = F.mul, F.mul_small, F.one
    ones: list[torch.Tensor] = []    # Z = 1 operands while a run takes them

    def mul(mod, a, b):
        if any(t is o for o in ones for t in (a, b)):
            return real_mul(mod, a, b)
        kind = f"{'sqr' if a is b else 'mul'}_{mod.name}"
        counts[kind] = counts.get(kind, 0) + 1
        return real_mul(mod, a, b)

    def with_ones(run):
        def one(*a, **k):
            ones.append(real_one(*a, **k))
            return ones[-1]
        F.one = one
        try:
            return run()
        finally:
            F.one = real_one
            ones.clear()

    def build_tables_run():
        return with_ones(lambda: build_tables_plain(x, y, flip))

    def comb_add_run():
        comb = F._const("comb", S._comb_table(), x)
        return with_ones(lambda: S.comb_add((x, y, x), comb, 0,
                                            torch.ones(1, dtype=torch.int64)))

    def mul_small(mod, a, k):
        counts["mul_small_p"] = counts.get("mul_small_p", 0) + 1
        return real_small(mod, a, k)

    x, y = F.from_int_array([1]), F.from_int_array([2])
    flip = torch.zeros(1, dtype=torch.int64)
    digit = torch.ones((1, 1), dtype=torch.int64)
    tabs = build_tables_plain(x, y, flip)
    point = torch.ones((1, 3, 8, 1), dtype=torch.int32)
    qtab = torch.ones((1, 16, 3, 8), dtype=torch.int32)
    runs = {  # name: (one run, windows)
        "verify_prep": (lambda: verify_prep_plain(x, y), 1),
        "inv_n": (lambda: S.inv_n(y), 1),
        "build_tables": (build_tables_run, 1),
        "glv_scan": (lambda: glv_scan_plain(digit, digit, digit, *tabs),
                     GLV.NDIGITS_GLV),
        "glv_scan2": (lambda: glv_scan2_plain(digit, digit, *tabs, point,
                                              point), GLV.NDIGITS_GLV),
        "dual_mul_v2": (lambda: dual_mul_v2_plain(digit, qtab, point),
                        S.NDIGITS),
        "dual_mul_planes": (lambda: dual_mul_planes_plain(point, point),
                            S.NDIGITS),
        "comb_add": (comb_add_run, 1),
        "inv_p": (lambda: S.inv_p(y), 1),
    }
    out = {}
    F.mul, F.mul_small = mul, mul_small
    try:
        for name, (run, windows) in runs.items():
            counts.clear()
            run()
            out[name] = {k: v * windows for k, v in counts.items()}
    finally:
        F.mul, F.mul_small = real_mul, real_small
    out["verify_prep_chain_per_signature"] = out["verify_prep"]
    prep = {k: v - out["inv_n"].get(k, 0)
            for k, v in out["verify_prep"].items()}
    for k, v in _batch_inversion_counts(out["inv_n"], "mul_n",
                                        PREP_THREADS, 1).items():
        prep[k] = prep.get(k, 0) + v
    out["verify_prep"] = {k: v for k, v in prep.items() if v}
    out["inv_p_batch"] = _batch_inversion_counts(out["inv_p"], "mul_p",
                                                 SIGN_THREADS, 0)
    out["inv_n_batch"] = _batch_inversion_counts(out["inv_n"], "mul_n",
                                                 SIGN_THREADS, 1)
    return out


# S2's Montgomery products a row besides its inversion: r into the
# domain, r d, s = (k^-1 R)(z + r d), and k into the domain (a chain a row)
# or k^-1 back into it (the batch inversion's output is plain)
SIGN_MUL_N = 4


def comb_op_counts(units: dict, adds: float, points: float, coords: int,
                   signs: float, batched: bool = True) -> dict[str, float]:
    """Field operations per row of S1 or S2 for what the data needs:
    `adds` comb additions (the nonzero digits of the scalars the kernel
    multiplies), `points` conversions to affine (an inversion mod p and
    `coords` products each), `signs` ECDSA finishes (an inversion mod n
    and SIGN_MUL_N Montgomery products).  Batched, as the kernels run, an
    inversion is a value's share of a block's batch inversion
    ("inv_p_batch", "inv_n_batch"); else a Fermat chain of its own
    ("inv_p", "inv_n"), the design S1 and S2 had before.  `units` is
    ``field_op_counts()``."""
    out: dict[str, float] = {}

    def put(counts, times):
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v * times

    batch = "_batch" if batched else ""
    put(units["comb_add"], adds)
    put(units["inv_p" + batch], points)
    put({"mul_p": coords}, points)
    put(units["inv_n" + batch], signs)
    put({"mul_n": SIGN_MUL_N}, signs)
    return {k: v for k, v in out.items() if v}


def nonzero_digits(k: torch.Tensor) -> torch.Tensor:
    """(..., 8, B) scalar words -> (..., B) count of nonzero 4-bit
    digits: the comb additions a scalar takes."""
    w = k.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 4, device=k.device)
    nib = (w[..., None] >> shifts) & 15
    return (nib != 0).sum(dim=(-3, -1))


def sign_work(ks: torch.Tensor, low: torch.Tensor) -> tuple[float, float]:
    """S2's comb additions and affine conversions a row, on average: each
    row tries its candidates up to the first whose r is low and nonzero
    (all C where none is).  ks: (C, 8, B) words; low: (C, B) bool."""
    C, B = low.shape
    first = torch.where(low.any(0), torch.argmax(low.to(torch.int64), 0),
                        C - 1)
    tried = torch.arange(C, device=low.device)[:, None] <= first[None, :]
    adds = (nonzero_digits(ks) * tried).sum().item() / B
    return adds, tried.sum().item() / B


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
