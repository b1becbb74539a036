"""The verify engines: every engine name the JAX package takes, the host
glue that feeds each engine's kernels, and batched ECDSA verify.

An engine name is ``<dual mul>`` or ``<dual mul>+<prep>`` (``+pp`` is the
``pallas`` prep), as the JAX package's ``resolve_dual_mul``,
``resolve_prep`` and ``_resolve_engine_names`` parse it
(lightning_tpu/crypto/secp256k1.py:551-614).  The port reads no
environment variable: the name is an ``engine=`` argument, by default
``pallas_fbj+pp``, the main path.

| dual mul | function | kernels on the card |
| --- | --- | --- |
| ``xla`` (``scan``) | ``secp256k1.dual_mul``, 64 windows | none: plain torch |
| ``glv`` | ``glv.dual_mul_glv``, 33 windows | none: plain torch |
| ``pallas`` | ``dual_mul_pallas`` | K6 |
| ``pallas_v2`` | ``dual_mul_pallas_v2`` | K5 |
| ``pallas_glv`` | ``dual_mul_pallas_glv`` | K4 |
| ``pallas_fb`` | ``dual_mul_pallas_fb`` | K2 + K4 |
| ``pallas_fbj`` | ``dual_mul_pallas_fbj`` | K2 + K3 |

| prep | function | kernels on the card |
| --- | --- | --- |
| ``xla`` | ``prep_xla``: decompress + ``field.inv_batch`` | none: plain torch |
| ``pallas`` (``+pp``) | ``hopper_secp.verify_prep`` | K1 |

``xla`` and ``glv`` are XLA stages in the JAX package; here they stay
plain PyTorch and launch no kernel.  The TPU engines select table entries
by one-hot einsums; here they are gathers in kernel-word layout: each
table is converted to 8 x 32-bit words first (``hopper_secp.to_words``)
and then gathered into (W, 3, 8, B) planes, so no radix-2^13 plane set is
ever built (for ``pallas`` at B = 65536 that would be two ~2 GB sets a
bucket).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as D
from . import field as F
from . import glv as GLV
from . import hopper_secp as H
from . import secp256k1 as S
from .field import FN, FP

DEFAULT_ENGINE = "pallas_fbj+pp"
VERIFY_BUCKET = 64


# ---------------------------------------------------------------------------
# Shared G tables in kernel words, and the selections


_SHARED = {
    "g": S._g_window_proj,
    "g_signed": lambda: GLV._signed_g_tables()[0],
    "phi_g_signed": lambda: GLV._signed_g_tables()[1],
}


@functools.lru_cache(maxsize=None)
def shared_words(name: str, device: str) -> torch.Tensor:
    """A constant fixed-base table in kernel words, (nv, 3, 8) int32:
    ``g`` is v*G (16 entries), ``g_signed`` / ``phi_g_signed`` the signed
    G / phi(G) tables (entry 16 + v is v*(-P))."""
    return H.to_words(torch.as_tensor(_SHARED[name](), device=device))


def _select_planes(tab, digits):
    """Per-key word table (B, 16, 3, 8), digits (W, B) -> the selected
    entries as (W, 3, 8, B) planes."""
    ar = torch.arange(tab.shape[0], device=tab.device)
    return tab[ar, digits].permute(0, 2, 3, 1).contiguous()


def _select_shared_planes(tab, idx):
    """Shared word table (nv, 3, 8), indices (W, B) -> (W, 3, 8, B)
    planes.  With a 32-entry signed table the index is digit + 16 * sign
    (the JAX package's _select_signed_shared_planes)."""
    return tab[idx].permute(0, 2, 3, 1).contiguous()


def _msb_planes(scalar, ndig):
    """Canonical limbs (B, 20) -> (ndig, B) 4-bit digits, most
    significant window first."""
    return S.digits4(scalar, ndig).flip(-1).T.contiguous()


# ---------------------------------------------------------------------------
# GLV prep


def _glv_split_digits(u1, u2):
    """GLV split of both scalars: the fixed-base digit planes and signs
    (d1l, d1h, s1l, s1h) and the per-key ones (d2l, d2h, s2l, s2h);
    planes are (33, B), signs (B,) bool."""
    m1l, s1l, m1h, s1h = GLV.split(u1)
    m2l, s2l, m2h, s2h = GLV.split(u2)
    d1l, d1h, d2l, d2h = (_msb_planes(m, GLV.NDIGITS_GLV)
                          for m in (m1l, m1h, m2l, m2h))
    return d1l, d1h, s1l, s1h, d2l, d2h, s2l, s2h


def _glv_prep(u1, u2):
    """The split, and the signed G and phi(G) points of every window
    selected outside the kernel: (d2l, d2h, s2l, s2h, g1, g2) with g1, g2
    (33, 3, 8, B) word planes."""
    d1l, d1h, s1l, s1h, d2l, d2h, s2l, s2h = _glv_split_digits(u1, u2)
    dev = str(u1.device)
    g1 = _select_shared_planes(shared_words("g_signed", dev),
                               d1l + 16 * s1l.to(torch.int64))
    g2 = _select_shared_planes(shared_words("phi_g_signed", dev),
                               d1h + 16 * s1h.to(torch.int64))
    return d2l, d2h, s2l, s2h, g1, g2


def glv_prep_joint(u1, u2):
    """The split, and the joint-table index plane
    g = d1l + 16 s1l + 32 (d1h + 16 s1h) that K3 gathers by:
    (d2l, d2h, s2l, s2h, gidx)."""
    d1l, d1h, s1l, s1h, d2l, d2h, s2l, s2h = _glv_split_digits(u1, u2)
    gidx = (d1l + 16 * s1l.to(torch.int64)
            + 32 * (d1h + 16 * s1h.to(torch.int64)))
    return d2l, d2h, s2l, s2h, gidx


def build_q_tables(qx, qy, s2l, s2h):
    """Sign prep + K2: the lo base is (qx, +-qy) by the sign of m2l, and
    the hi table flips y where the signs of m2l and m2h differ."""
    qy_neg = F.sub(FP, torch.zeros_like(qy), qy)
    byl = torch.where(s2l[:, None], qy_neg, qy)
    return H.build_tables(qx, byl, (s2l ^ s2h).to(torch.int64))


# ---------------------------------------------------------------------------
# The dual multiplications u1*G + u2*Q: canonical scalars and affine Q
# in, a projective point of three (B, 20) limb tensors out


def dual_mul_pallas(u1, u2, qx, qy):
    """K6: Q and G points of all 64 windows selected outside the kernel
    from the per-key table v*Q and the G table."""
    d1, d2 = _msb_planes(u1, S.NDIGITS), _msb_planes(u2, S.NDIGITS)
    qs = _select_planes(H.to_words(S._build_window(qx, qy)), d2)
    gs = _select_shared_planes(shared_words("g", str(u1.device)), d1)
    return H.dual_mul_planes(qs, gs)


def dual_mul_pallas_v2(u1, u2, qx, qy):
    """K5: the per-key table v*Q goes in whole and is selected in the
    kernel; the G points are selected outside."""
    d1, d2 = _msb_planes(u1, S.NDIGITS), _msb_planes(u2, S.NDIGITS)
    qtab = H.to_words(S._build_window(qx, qy))
    gs = _select_shared_planes(shared_words("g", str(u1.device)), d1)
    return H.dual_mul_v2(d2, qtab, gs)


def dual_mul_pallas_glv(u1, u2, qx, qy):
    """K4 with the per-key tables built in plain torch: lo = v*(qx, +-qy)
    by the sign of m2l, hi = phi(v*Q) with y signed by m2h (XLA in the
    JAX package)."""
    d2l, d2h, s2l, s2h, g1, g2 = _glv_prep(u1, u2)
    tx, ty, tz = S._build_window(qx, qy).permute(2, 1, 0, 3)  # (16, B, 20)
    ty_neg = F.sub(FP, torch.zeros_like(ty), ty)
    lo = (tx, torch.where(s2l[:, None], ty_neg, ty), tz)
    hi = (F.mul(FP, tx, GLV._const(GLV.BETA, tx)),
          torch.where(s2h[:, None], ty_neg, ty), tz)
    return H.glv_scan2(d2l, d2h, H.as_tables(lo, hi), g1, g2)


def dual_mul_pallas_fb(u1, u2, qx, qy):
    """K2 builds the per-key tables, K4 scans with the signed G and
    phi(G) points selected outside."""
    d2l, d2h, s2l, s2h, g1, g2 = _glv_prep(u1, u2)
    tables = build_q_tables(qx, qy, s2l, s2h)
    return H.glv_scan2(d2l, d2h, tables, g1, g2)


def dual_mul_pallas_fbj(u1, u2, qx, qy):
    """K2 builds the per-key tables, K3 scans with the joint G / phi(G)
    table (the main path)."""
    d2l, d2h, s2l, s2h, gidx = glv_prep_joint(u1, u2)
    tables = build_q_tables(qx, qy, s2l, s2h)
    return H.glv_scan(d2l, d2h, gidx, tables)


# ---------------------------------------------------------------------------
# Engine names


def prep_xla(qx, parity, s):
    """The ``xla`` prep: (qy with the requested parity, on_curve, s^-1
    mod n) by decompress and the batched Montgomery inversion."""
    qy, on_curve = S.decompress(qx, parity)
    return qy, on_curve, F.inv_batch(FN, s)


DUAL_MUL = {
    "xla": S.dual_mul,
    "scan": S.dual_mul,
    "glv": GLV.dual_mul_glv,
    "pallas": dual_mul_pallas,
    "pallas_v2": dual_mul_pallas_v2,
    "pallas_glv": dual_mul_pallas_glv,
    "pallas_fb": dual_mul_pallas_fb,
    "pallas_fbj": dual_mul_pallas_fbj,
}
PREP = {"xla": prep_xla, "pallas": H.verify_prep}


def resolve_dual_mul(name: str):
    """The u1*G + u2*Q function of a dual-mul engine name; KeyError for
    an unknown one."""
    if name not in DUAL_MUL:
        raise KeyError(f"unknown dual-mul engine {name!r}")
    return DUAL_MUL[name]


def resolve_prep(name: str):
    """The (qx, parity, s) -> (qy, on_curve, w) function of a prep
    engine name; KeyError for an unknown one."""
    if name not in PREP:
        raise KeyError(f"unknown verify-prep engine {name!r}")
    return PREP[name]


def resolve_engine_names(engine: str):
    """``impl`` or ``impl+suffix`` -> (impl, prep) names: the suffix
    names the prep (``pp`` is ``pallas``); without one the prep is
    ``xla``."""
    if "+" not in engine:
        return engine, "xla"
    impl, suffix = engine.split("+", 1)
    return impl, {"pp": "pallas"}.get(suffix, suffix)


def resolve_engine(engine: str):
    """An engine name -> its (prep, dual_mul) pair of functions."""
    impl, prep = resolve_engine_names(engine)
    return resolve_prep(prep), resolve_dual_mul(impl)


# ---------------------------------------------------------------------------
# ECDSA


def ecdsa_verify_kernel(z, r, s, qx, q_parity, engine: str = DEFAULT_ENGINE):
    """Batched ECDSA verify under one engine.  z: (B, 20) hash limbs
    (raw 256-bit value); r, s: canonical signature scalars; qx: canonical
    pubkey x limbs; q_parity: (B,) y parity.  Returns bool (B,); invalid
    encodings give False."""
    prep, dual_mul = resolve_engine(engine)
    r_ok = F.lt_const(r, S.N_INT) & F.nonzero(r)
    # libsecp256k1's verify rejects high-S outright: s <= (n-1)/2 only
    s_ok = F.lt_const(s, (S.N_INT + 1) // 2) & F.nonzero(s)
    q_ok = F.lt_const(qx, S.P_INT)
    qy, on_curve, w = prep(qx, q_parity, s)
    u1 = F.normalize(FN, F.mul(FN, z, w))
    u2 = F.normalize(FN, F.mul(FN, r, w))
    Rx, _, Rz = dual_mul(u1, u2, qx, qy)
    not_inf = ~F.is_zero(FP, Rz)
    # projective x(R) = r (mod n) without inversion: x(R) = Rx / Rz and
    # the candidates r' in {r, r + n} with r' < p
    chk1 = F.eq(FP, Rx, S._mul(r, Rz))
    r_plus_n = S._add(r, F.from_const(S.N_INT, r.shape[:-1], r.device))
    small_r = F.lt_const(r, S.P_INT - S.N_INT)
    chk2 = small_r & F.eq(FP, Rx, S._mul(r_plus_n, Rz))
    return r_ok & s_ok & q_ok & on_curve & not_inf & (chk1 | chk2)


@torch.inference_mode()
def ecdsa_verify_batch(msg_hashes: np.ndarray, sigs64: np.ndarray,
                       pubkeys33: np.ndarray, bucket: int = VERIFY_BUCKET,
                       engine: str = DEFAULT_ENGINE,
                       device=None) -> np.ndarray:
    """msg_hashes: (B, 32) uint8; sigs64: (B, 64) compact r || s;
    pubkeys33: (B, 33) SEC1 compressed.  Verifies in slices of `bucket`
    on `device` (the card unless device="cpu") and returns bool (B,); a
    key tag other than 0x02 / 0x03 fails.  Every batch goes to the
    device: the exact-int oracle is ``secp256k1.host_verify_batch``."""
    dev = D.resolve(device)
    out = np.zeros(msg_hashes.shape[0], bool)
    for start in range(0, len(out), bucket):
        sl = slice(start, start + bucket)
        z, sig, pub = (torch.from_numpy(np.ascontiguousarray(a[sl]))
                       .to(dev) for a in (msg_hashes, sigs64, pubkeys33))
        ok = ecdsa_verify_kernel(
            F.from_bytes_be_dev(z), F.from_bytes_be_dev(sig[:, :32]),
            F.from_bytes_be_dev(sig[:, 32:]), F.from_bytes_be_dev(pub[:, 1:]),
            pub[:, 0].to(torch.int64) & 1, engine)
        out[sl] = ok.cpu().numpy()
    tag_ok = (pubkeys33[:, 0] == 2) | (pubkeys33[:, 0] == 3)
    return out & tag_ok
