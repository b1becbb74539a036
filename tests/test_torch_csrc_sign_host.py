"""The sign kernels' arithmetic (S1, S2), compiled for the host.

The header lightning_tpu_torch/crypto/csrc/secp256k1.cuh is __host__
__device__ throughout, so the bodies of S1 (``fixed_base_one``: the comb
``comb_mul_one`` and the inversion mod p ``fp_inv``) and of S2
(``sign_one<C>``, with ``fn_add`` and the Montgomery products mod n)
build with the host C++ compiler.  Here they run on the CPU against the
exact-int oracle: k*G against ``ref.point_mul``, signatures against the
four-candidate rule ``engines.sign_with_candidates``.  The PTX carry
chains of the device pass, the table's read-only loads and the launch are
held on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import ref_python as jref
from lightning_tpu_torch import _build
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import hopper_secp as H

torch.set_num_threads(1)

P, N = jref.P, jref.N

SHIM = r"""
#include "secp256k1.cuh"
extern "C" {
void c_fp_inv(uint32_t *r, const uint32_t *a) { fp_inv(r, a); }
void c_fn_add(uint32_t *r, const uint32_t *a, const uint32_t *b) {
    fn_add(r, a, b);
}
void c_fixed_base(const uint32_t *k, const uint32_t *comb, uint32_t *x,
                  uint32_t *y) { fixed_base_one(k, comb, x, y); }
// ks: C candidates of 8 words each (stride 1); flags: ok, grind
void c_sign(int C, const uint32_t *z, const uint32_t *d, const uint32_t *ks,
            const uint32_t *comb, uint32_t *r, uint32_t *s, uint32_t *flags) {
    if (C == 1) sign_one<1>(z, d, ks, 1, comb, r, s, flags[0], flags[1]);
    else sign_one<4>(z, d, ks, 1, comb, r, s, flags[0], flags[1]);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("csrc_sign_host")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    out = d / "libshim.so"
    subprocess.run(["c++", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", _build.CRYPTO_CSRC, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def comb():
    return H._comb_words("cpu").numpy().view(np.uint32).copy()


def _w8(x: int) -> np.ndarray:
    return np.array([(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)],
                    np.uint32)


def _int(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _key(tag: bytes) -> int:
    return int.from_bytes(hashlib.sha256(tag).digest(), "big") % (N - 1) + 1


def test_fp_inv_and_fn_add_match_oracle(lib):
    """a^-1 mod p by the chain (0 -> 0) and (a + b) mod n at the carry
    edges: sums that carry out of 256 bits and sums in [n, 2^256)."""
    rng = np.random.default_rng(61)
    vals = [0, 1, 2, P - 1, P - 2, 2**255, 2**32 - 1] + [
        int.from_bytes(rng.bytes(32), "big") % P for _ in range(6)]
    for a in vals:
        out = np.zeros(8, np.uint32)
        lib.c_fp_inv(_ptr(out), _ptr(_w8(a)))
        assert _int(out) == (pow(a, P - 2, P))
    nvals = [0, 1, N - 1, N - 2, (N - 1) // 2, (N + 1) // 2, 2**255,
             2**32] + [int.from_bytes(rng.bytes(32), "big") % N
                       for _ in range(4)]
    for a in nvals:
        for b in nvals:
            out = np.zeros(8, np.uint32)
            lib.c_fn_add(_ptr(out), _ptr(_w8(a)), _ptr(_w8(b)))
            assert _int(out) == (a + b) % N


# k = 1, 2^(4j) (every digit 0 but one), n - 1, digits of 0 inside, and
# k = 0 and n (infinity: x = y = 0)
FIXED_KS = [1, 2, 15, 16, 2**4, 2**128, 2**252, 0xF << 252, N - 1, N - 2,
            0x1000000010000001, 2**256 - 1, 0, N]


def test_fixed_base_body_matches_oracle(lib, comb):
    rng = np.random.default_rng(62)
    ks = FIXED_KS + [int.from_bytes(rng.bytes(32), "big") for _ in range(4)]
    for k in ks:
        x, y = np.zeros(8, np.uint32), np.zeros(8, np.uint32)
        lib.c_fixed_base(_ptr(_w8(k)), _ptr(comb), _ptr(x), _ptr(y))
        want = jref.point_mul(k, jref.G)
        assert (_int(x), _int(y)) == ((0, 0) if want.inf
                                      else (want.x, want.y)), hex(k)


def _sign_rows():
    """(z, d, candidates): the all-high-R row of hash sha256(b"h14") and
    key from b"d14" (no low R among its first four RFC6979 nonces), z =
    2^256 - 1 and z = n + 5 (z >= n), k = 1 and k = n - 1, and seeded
    rows."""
    rows = []
    for i in (14, 3, 7):
        h = hashlib.sha256(b"h%d" % i).digest()
        d = _key(b"d%d" % i)
        rows.append((int.from_bytes(h, "big"), d,
                     E.rfc6979_candidates(h, d)))
    rng = np.random.default_rng(63)
    rand = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
            for _ in range(12)]
    rows.append((2**256 - 1, rand[0], rand[1:5]))
    rows.append((N + 5, rand[5], rand[6:10]))
    rows.append((rand[10], rand[11], [1, N - 1, 2**128, 3]))
    return rows


@pytest.mark.parametrize("C", [1, 4])
def test_sign_body_matches_four_candidate_rule(lib, comb, C):
    rows = _sign_rows()
    grinds = []
    for z, d, ks in rows:
        r, s, flags = (np.zeros(8, np.uint32), np.zeros(8, np.uint32),
                       np.zeros(2, np.uint32))
        kw = np.concatenate([_w8(k) for k in ks[:C]])
        lib.c_sign(ctypes.c_int(C), _ptr(_w8(z)), _ptr(_w8(d)), _ptr(kw),
                   _ptr(comb), _ptr(r), _ptr(s), _ptr(flags))
        wr, ws, wok, wgrind = E.sign_with_candidates(z, d, ks[:C])
        assert (_int(r), _int(s), bool(flags[0]), bool(flags[1])) == \
            (wr, ws, wok, wgrind)
        grinds.append(wgrind)
    if C == 4:
        assert not grinds[0] and all(grinds[1:3])   # h14 has no low R
