"""The plain versions of the port's three kernels (K1 verify prep, K2
table build, K3 GLV scan) against the JAX package's exact-int oracle
crypto/ref_python.py, the reference tests/test_pallas_secp.py pins the
Pallas kernels to.  Projective outputs are compared as affine points;
everything is exact.  B = 8, CPU tensors (the wrappers take the plain
versions for CPU tensors)."""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import ref_python as ref
from lightning_tpu_torch import _build
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import glv as GLV
from lightning_tpu_torch.crypto import hopper_secp as H

torch.set_num_threads(1)

B = 8
P, N = ref.P, ref.N


def _keys(rng, n):
    return [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % (N - 1)
                              + 1) for _ in range(n)]


def _affine(X, Y, Z, i):
    x, y, z = (F.limbs_to_int(t[i]) % P for t in (X, Y, Z))
    if z == 0:
        return ref.INFINITY
    zi = pow(z, -1, P)
    return ref.Point(x * zi % P, y * zi % P)


def _off_curve_x():
    return next(x for x in range(1, 100)
                if pow((x ** 3 + 7) % P, (P - 1) // 2, P) != 1)


def test_verify_prep_plain_matches_oracle():
    rng = np.random.default_rng(21)
    pts = _keys(rng, B - 3)
    xs = [p.x for p in pts] + [_off_curve_x(), 0, 2**256 - 1]
    ss = [int.from_bytes(rng.bytes(32), "big") for _ in range(B - 3)]
    ss += [0, N - 1, N]
    y, d, w = H.verify_prep_core(F.from_int_array(xs), F.from_int_array(ss))
    for i, (x, s) in enumerate(zip(xs, ss)):
        y2 = (x ** 3 + 7) % P
        yi = F.limbs_to_int(y[i]) % P
        assert yi == pow(y2, (P + 1) // 4, P)
        assert F.limbs_to_int(d[i]) % P == (yi * yi - y2) % P
        assert F.limbs_to_int(w[i]) % N == pow(s % N, N - 2, N)


def test_verify_prep_wrapper_decompresses():
    rng = np.random.default_rng(22)
    pts = _keys(rng, B - 1)
    xs = [p.x for p in pts] + [_off_curve_x()]
    parity = torch.as_tensor([p.y & 1 for p in pts] + [0])
    flipped = torch.as_tensor([1, 0, 1, 0, 1, 0, 1, 0])
    par = parity ^ flipped
    qy, on_curve, _ = H.verify_prep(F.from_int_array(xs), par,
                                    F.from_int_array([1] * B))
    assert on_curve.tolist() == [True] * (B - 1) + [False]
    for i, p in enumerate(pts):
        want = ref.pubkey_parse(bytes([2 + int(par[i])])
                                + p.x.to_bytes(32, "big")).y
        assert F.limbs_to_int(qy[i]) % P == want


@pytest.mark.parametrize("flip", [0, 1])
def test_build_tables_plain_matches_oracle(flip):
    rng = np.random.default_rng(23 + flip)
    pts = _keys(rng, B)
    bx = F.from_int_array([p.x for p in pts])
    by = F.from_int_array([p.y for p in pts])
    lo, hi = H.build_tables_plain(bx, by, torch.full((B,), flip))
    for i, p in enumerate(pts):
        for v in range(16):
            want = ref.point_mul(v, p)
            got_lo = _affine(*(c[v] for c in lo), i)
            got_hi = _affine(*(c[v] for c in hi), i)
            assert got_lo == want
            if want.inf:
                assert got_hi.inf
            else:
                hy = (P - want.y) % P if flip else want.y
                assert got_hi == ref.Point(GLV.BETA * want.x % P, hy)


def test_glv_scan_plain_matches_oracle():
    """K2 + K3 (dual_mul_pallas_fbj) = u1*G + u2*Q, including u = 0, u = n - 1
    and a sum at infinity."""
    rng = np.random.default_rng(25)
    pts = _keys(rng, B)
    u1 = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    u2 = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    u1[0], u2[1], u1[2], u2[3] = 0, 0, N - 1, N - 1
    pts[4] = ref.G                       # u1*G + u2*G with u2 = n - u1
    u2[4] = N - u1[4]
    X, Y, Z = E.dual_mul_pallas_fbj(
        F.from_int_array(u1), F.from_int_array(u2),
        F.from_int_array([p.x for p in pts]),
        F.from_int_array([p.y for p in pts]))
    for i, p in enumerate(pts):
        want = ref.point_add(ref.point_mul(u1[i], ref.G),
                             ref.point_mul(u2[i], p))
        assert _affine(X, Y, Z, i) == want, i
    assert F.limbs_to_int(Z[4]) % P == 0


def test_glv_scan_plain_matches_dual_mul_glv():
    """The joint-table scan equals the four-table GLV scan and the plain
    64-window dual_mul as points."""
    from lightning_tpu_torch.crypto import secp256k1 as S

    rng = np.random.default_rng(26)
    pts = _keys(rng, 3)
    u1 = F.from_int_array([int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(3)])
    u2 = F.from_int_array([int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(3)])
    qx = F.from_int_array([p.x for p in pts])
    qy = F.from_int_array([p.y for p in pts])
    a = E.dual_mul_pallas_fbj(u1, u2, qx, qy)
    b = GLV.dual_mul_glv(u1, u2, qx, qy)
    c = S.dual_mul(u1, u2, qx, qy)
    for i in range(3):
        assert _affine(*a, i) == _affine(*b, i) == _affine(*c, i)


def test_field_op_counts():
    """RCB doubling: 2 squarings + 6 multiplications + 1 small multiple;
    addition: 12 multiplications + 2 small multiples; K2's addition of its
    base (Z = 1, pt_add_z1) 11, and the first of them, Q + Q, squares its
    X and Y products; sqrt_p: 253
    squarings + 13 multiplications; inv_n: 255 squarings + 81
    multiplications, which K1 runs once a block of 256 signatures.  Per
    window, K3 does 4 doublings and 3 additions, K4 4 and 4 (33 windows),
    K5 and K6 4 and 2 (64 windows)."""
    counts = H.field_op_counts()

    def scan(windows, adds):
        return {"sqr_p": windows * 4 * 2,
                "mul_p": windows * (4 * 6 + adds * 12),
                "mul_small_p": windows * (4 + adds * 2)}

    assert counts["glv_scan"] == scan(33, 3)
    assert counts["glv_scan2"] == scan(33, 4)
    assert counts["dual_mul_v2"] == counts["dual_mul_planes"] == scan(64, 2)
    assert counts["build_tables"] == {"sqr_p": 2,
                                      "mul_p": 14 * 11 - 2 + 15,
                                      "mul_small_p": 28}
    chain = {"sqr_n": 255, "mul_n": 81}
    sqrt = {"sqr_p": 1 + 253 + 3, "mul_p": 1 + 13 + 1}
    assert counts["verify_prep_chain_per_signature"] == {**sqrt, **chain}
    # K1's batch inversion, the fewest products of Montgomery's trick: 3
    # Montgomery products a signature and 1 to enter the domain, and one
    # chain plus 1 to leave it a block of 256
    assert counts["verify_prep"] == {
        **sqrt, "sqr_n": 255 / 256, "mul_n": 4 + (81 + 1) / 256}


def test_comb_op_counts_batched_and_per_row():
    """S1's and S2's inversions as the kernels run them, one batch
    inversion a block of 512 (Montgomery's trick's 3 products a value mod
    p, 4 mod n with entering the Montgomery domain; the chain, one more mod
    n, a block), against a Fermat chain a value (inv_p: 255
    squarings + 15 multiplications; inv_n: 255 + 81): the two designs'
    counts differ by exactly that swap, a point's and a signature's."""
    counts = H.field_op_counts()
    assert counts["inv_p"] == {"sqr_p": 255, "mul_p": 15}
    assert counts["inv_n"] == {"sqr_n": 255, "mul_n": 81}
    assert counts["inv_p_batch"] == {"sqr_p": 255 / 512,
                                     "mul_p": 3 + 15 / 512}
    assert counts["inv_n_batch"] == {"sqr_n": 255 / 512,
                                     "mul_n": 4 + (81 + 1) / 512}
    adds, points, signs = 112.5, 1.875, 1.0
    batched = H.comb_op_counts(counts, adds, points, 1, signs)
    per_row = H.comb_op_counts(counts, adds, points, 1, signs,
                               batched=False)
    assert set(batched) == set(per_row)
    for kind in batched:
        mod = kind[-1]
        swap = (points if mod == "p" else signs) * (
            counts[f"inv_{mod}_batch"].get(kind, 0)
            - counts[f"inv_{mod}"].get(kind, 0))
        assert batched[kind] - per_row[kind] == pytest.approx(swap)
    comb = {k: v * adds for k, v in counts["comb_add"].items()}
    assert per_row == pytest.approx({
        "sqr_p": 255 * points, "sqr_n": 255 * signs,
        "mul_p": comb["mul_p"] + (15 + 1) * points,
        "mul_small_p": comb["mul_small_p"],
        "mul_n": (81 + H.SIGN_MUL_N) * signs})


@pytest.mark.parametrize("kernel,define,want", [
    ("verify_prep", "PREP_THREADS", H.PREP_THREADS),
    ("fixed_base", "S1_THREADS", H.SIGN_THREADS),
    ("ecdsa_sign", "S2_THREADS", H.SIGN_THREADS)])
def test_block_sizes_match_sources(kernel, define, want):
    """The block sizes the bounds count are the ones the kernels launch."""
    with open(_build.source_path(kernel)) as f:
        got = re.findall(rf"^#define {define} (\d+)\b", f.read(), re.M)
    assert got == [str(want)]
