"""The verify engines: every engine name the JAX package takes, the host
glue that feeds each engine's kernels, and batched ECDSA verify; and the
sign path's batch entry points (ECDSA sign, k*G, BIP340 verify) with
their exact-int oracles.

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
import hashlib
import time

import numpy as np
import torch

from .. import device as D
from . import field as F
from . import glv as GLV
from . import hopper_secp as H
from . import ref_python as ref
from . import secp256k1 as S
from . import sha256 as SHA
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


# ---------------------------------------------------------------------------
# ECDSA sign and k*G (S2 and S1), BIP340 verify

GRIND_CANDIDATES = S.GRIND_CANDIDATES
SIGN_BUCKET = 65536


def rfc6979_candidates(msg_hash: bytes, seckey: int,
                       count: int = GRIND_CANDIDATES) -> list[int]:
    """The first `count` nonces of the low-R grinding stream: RFC6979
    with no extra data, then with c.to_bytes(32, "little") for c >= 1
    (the counter libsecp256k1's sign_hash passes as ndata)."""
    return [ref.rfc6979_nonce(msg_hash, seckey,
                              None if c == 0 else c.to_bytes(32, "little"))
            for c in range(count)]


def sign_with_candidates(z: int, d: int,
                         ks: list[int]) -> tuple[int, int, bool, bool]:
    """S2's rule in exact ints, candidate by candidate: r = x(k*G) mod n
    of the first candidate whose r is below 2^255 and nonzero, else of
    candidate 0; s = k^-1 (z + r d) mod n, low-S.  Returns (r, s, ok,
    grind_ok): ok is r and s nonzero, grind_ok that a low-R candidate was
    found."""
    r = kk = 0
    grind = False
    for c, k in enumerate(ks):
        rc = ref.point_mul(k, ref.G).x % ref.N
        if c == 0:
            r, kk = rc, k
        if 0 < rc < 2**255:
            r, kk, grind = rc, k, True
            break
    s = pow(kk, -1, ref.N) * (z + r * d) % ref.N if kk % ref.N else 0
    ok = r != 0 and s != 0
    if s > S.HALF_N:
        s = ref.N - s
    return r, s, ok, grind


def host_sign_batch(msg_hashes: np.ndarray, seckeys: list[int]) -> np.ndarray:
    """The JAX package's host signer (lightning_tpu/crypto/secp256k1.py
    :765): ``ref.ecdsa_sign``, which grinds the RFC6979 stream until r is
    low, with no bound on the candidates.  (B, 64) compact r || s."""
    out = np.empty((msg_hashes.shape[0], 64), np.uint8)
    for i, (h, d) in enumerate(zip(msg_hashes, seckeys)):
        r, s = ref.ecdsa_sign(bytes(h), d)
        out[i] = np.frombuffer(r.to_bytes(32, "big") + s.to_bytes(32, "big"),
                               np.uint8)
    return out


def host_sign_grind_batch(msg_hashes: np.ndarray, seckeys: list[int],
                          candidates: int = GRIND_CANDIDATES) -> np.ndarray:
    """``ecdsa_sign_batch`` in exact ints: the rule of
    ``sign_with_candidates`` over the first `candidates` RFC6979 nonces.
    It differs from ``host_sign_batch`` on a row with no low-R nonce among
    them (about 1 in 16 for four), where this takes candidate 0's high R.
    (B, 64) compact r || s; raises on a degenerate row, as the batch
    does."""
    out = np.empty((msg_hashes.shape[0], 64), np.uint8)
    for i, (h, d) in enumerate(zip(msg_hashes, seckeys)):
        h = bytes(h)
        r, s, ok, _ = sign_with_candidates(
            int.from_bytes(h, "big"), d, rfc6979_candidates(h, d, candidates))
        if not ok:
            raise RuntimeError(f"degenerate nonce at row {i}")
        out[i] = np.frombuffer(r.to_bytes(32, "big") + s.to_bytes(32, "big"),
                               np.uint8)
    return out


def _sign_rows(z: np.ndarray, d: np.ndarray, ks: np.ndarray, bucket: int,
               dev) -> np.ndarray:
    """S2 over slices of `bucket` rows: z, d (B, 32) and ks (B, C, 32)
    big-endian bytes -> (B, 64) compact signatures; raises where r or s
    is 0."""
    out = np.empty((z.shape[0], 64), np.uint8)
    for start in range(0, z.shape[0], bucket):
        sl = slice(start, start + bucket)
        k8 = torch.stack([F.words_from_be_bytes(ks[sl, c], dev)
                          for c in range(ks.shape[1])])
        r, s, ok, _ = H.ecdsa_sign(F.words_from_be_bytes(z[sl], dev),
                                   F.words_from_be_bytes(d[sl], dev), k8)
        bad = np.nonzero(~ok.cpu().numpy())[0]
        if len(bad):
            raise RuntimeError(f"degenerate nonce at rows "
                               f"{(bad + start)[:8].tolist()}")
        out[sl, :32] = F.words_to_be_bytes(r)
        out[sl, 32:] = F.words_to_be_bytes(s)
    return out


@torch.inference_mode()
def ecdsa_sign_batch(msg_hashes: np.ndarray, seckeys: list[int],
                     bucket: int = SIGN_BUCKET, device=None,
                     seconds: dict | None = None) -> np.ndarray:
    """Batched deterministic ECDSA sign: (B, 32) uint8 hashes and B secret
    keys in [1, n) -> (B, 64) compact r || s, low-S.  The four RFC6979
    candidates of each row are made on the host; S2 (C = 4) grinds them
    on `device` (the card unless device="cpu") in slices of `bucket`
    rows.  The result is ``host_sign_grind_batch``'s, byte for byte.

    Where the JAX package pads each slice with rows of k = 1, z = 0 and
    d = 0, the kernel masks its ragged edge, so no padding row is signed.
    Every batch signs on the device: the JAX package's micro-batch branch
    (B <= HOST_VERIFY_MAX = 2 signs on the host, secp256k1.py :787) is a
    host escape the port does not have.  So for B <= 2, on a row with no
    low-R candidate among the four, the JAX package returns a low-R
    signature from further down the stream and the port candidate 0's
    high-R one.  Pass a dict as `seconds` to get the host nonce time
    ("nonces") and the device time ("device", operands in, signatures
    back)."""
    dev = D.resolve(device)
    t0 = time.perf_counter()
    ks = np.stack([F.ints_to_be_bytes(rfc6979_candidates(bytes(h), d))
                   for h, d in zip(msg_hashes, seckeys)]) \
        if len(seckeys) else np.zeros((0, GRIND_CANDIDATES, 32), np.uint8)
    t1 = time.perf_counter()
    out = _sign_rows(msg_hashes, F.ints_to_be_bytes(seckeys), ks, bucket, dev)
    if seconds is not None:
        seconds["nonces"] = t1 - t0
        seconds["device"] = time.perf_counter() - t1
    return out


@torch.inference_mode()
def ecdsa_sign_simple(msg_hashes: np.ndarray, seckeys: list[int],
                      nonces: list[int], bucket: int = SIGN_BUCKET,
                      device=None) -> np.ndarray:
    """ECDSA with the caller's nonces (one a row, no grinding), low-S:
    S2 with C = 1, the JAX package's ecdsa_sign_simple_kernel.  (B, 64)
    compact r || s; raises where r or s is 0."""
    dev = D.resolve(device)
    ks = F.ints_to_be_bytes(nonces)[:, None]
    return _sign_rows(msg_hashes, F.ints_to_be_bytes(seckeys), ks, bucket,
                      dev)


@torch.inference_mode()
def derive_pubkeys(seckeys, bucket: int = SIGN_BUCKET,
                   device=None) -> np.ndarray:
    """(B, 20) canonical secret-key limbs -> (B, 33) compressed SEC1
    public keys, d*G by S1 on `device` (the card unless device="cpu")."""
    dev = D.resolve(device)
    limbs = torch.as_tensor(np.asarray(seckeys, np.int64))
    out = np.empty((limbs.shape[0], 33), np.uint8)
    for start in range(0, limbs.shape[0], bucket):
        sl = slice(start, start + bucket)
        x, y = H.fixed_base_affine(F.to_u32x8(limbs[sl]).to(dev))
        out[sl, 0] = 2 + (y[0].cpu().numpy() & 1)
        out[sl, 1:] = F.words_to_be_bytes(x)
    return out


@torch.inference_mode()
def schnorr_verify_batch(msgs32: np.ndarray, sigs64: np.ndarray,
                         pubkeys32: np.ndarray, bucket: int = VERIFY_BUCKET,
                         device=None) -> np.ndarray:
    """BIP340 verify of 32-byte messages: (B, 32), (B, 64) and (B, 32)
    uint8 -> bool (B,).  The challenge is hashed by ``crypto/sha256.py``
    and s*G - e*P runs on the main path's scan (``dual_mul_pallas_fbj``,
    K2 + K3 on the card); the lift of P, the affine step and the parity
    check are plain torch, as they are XLA stages in the JAX package."""
    dev = D.resolve(device)
    th = hashlib.sha256(b"BIP0340/challenge").digest()
    msgs = [th + th + bytes(sig[:32]) + bytes(pk) + bytes(m)
            for m, sig, pk in zip(msgs32, sigs64, pubkeys32)]
    out = np.zeros(len(msgs), bool)
    for start in range(0, len(msgs), bucket):
        sl = slice(start, start + bucket)
        blocks, nblocks = SHA.pack_messages(msgs[sl])
        e = SHA.digest_words_to_limbs(SHA.sha256_blocks(
            torch.from_numpy(blocks).to(dev),
            torch.from_numpy(nblocks).to(dev)))
        sig = torch.from_numpy(np.ascontiguousarray(sigs64[sl])).to(dev)
        px = torch.from_numpy(np.ascontiguousarray(pubkeys32[sl])).to(dev)
        ok = S.schnorr_verify_kernel(
            e, F.from_bytes_be_dev(sig[:, :32]),
            F.from_bytes_be_dev(sig[:, 32:]), F.from_bytes_be_dev(px),
            dual_mul_pallas_fbj)
        out[sl] = ok.cpu().numpy()
    return out
