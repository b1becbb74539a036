"""The sign kernels' arithmetic (S1, S2), compiled for the host.

The header lightning_tpu_torch/crypto/csrc/secp256k1.cuh is __host__
__device__ throughout, so the steps of S1 (the comb ``comb_mul_one`` and
the batch inversion mod p ``fp_inv_batch``) and of S2 (the candidate
rounds of ``sign_tile``: ``sign_job``, ``sign_job_r``, ``sign_decide``,
then the batch inversion mod n and ``sign_finish``) build with the host
C++ compiler.  The shim below runs them over a simulated block, each step
as a loop over its threads, with the packing of the pending rows as a
sequential scan; here they run on the CPU against the exact-int oracle:
k*G against ``ref.point_mul``, signatures against the four-candidate rule
``engines.sign_with_candidates``.  The PTX carry chains of the device
pass, the warp scans and ballots, the table's read-only loads and the
launch are held on the card (tests/test_torch_gpu.py, chip_smoke.py).
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
T = 32        # threads of the simulated block

SHIM = r"""
#include <vector>
#include "secp256k1.cuh"
#define TB 32
// S2's tile of n <= TB rows with TB threads, each step a loop over the
// threads; z, d (8, n) and ks (C, 8, n) word planes, r, s (n, 8) words,
// flags (n, 2): ok, grind; rounds: the rounds the tile took.
template <int C>
static int tile(int n, const uint32_t *z, const uint32_t *d,
                const uint32_t *ks, const uint32_t *comb, uint32_t *r,
                uint32_t *s, uint32_t *flags) {
    static sign_tile<TB> st;
    std::vector<pt> acc(TB);
    std::vector<uint32_t> zs(8 * TB), zi(8 * TB), a(8 * TB), pre(8 * TB);
    int rows[TB], pend[TB], rounds = 0;
    for (int t = 0; t < TB; t++) sign_tile_start(st, t, n);
    for (int round = 0; round < C && st.p > 0; round++, rounds++) {
        const int p = st.p;
        for (int t = 0; t < TB; t++) {
            int cand = 0;
            rows[t] = sign_job<C>(st, t, p, cand);
            fe_set_small(&zs[8 * t], 1);
            if (rows[t] < 0) continue;
            uint32_t k[8];
            fe_load(k, ks + (long long)(8 * cand) * n + rows[t], n);
            comb_mul_one(acc[t], k, comb);
            fe_copy(&zs[8 * t], acc[t].z);
        }
        fp_inv_batch(zi.data(), zs.data(), a.data(), pre.data(), TB);
        for (int t = 0; t < TB; t++)
            if (rows[t] >= 0) sign_job_r(st, t, acc[t].x, &zi[8 * t]);
        for (int t = 0; t < p; t++)
            pend[t] = sign_decide<C>(st, t, p, rows[t]);
        int q = 0;
        for (int t = 0; t < p; t++)
            if (pend[t]) st.list[q++] = (uint16_t)rows[t];
        st.p = q;
    }
    std::vector<uint32_t> k(8 * n), w(8 * n);
    a.resize(8 * n);
    pre.resize(8 * n);
    for (int t = 0; t < n; t++)
        fe_load(&k[8 * t], ks + (long long)(8 * st.sel[t]) * n + t, n);
    fn_inv_batch(w.data(), k.data(), a.data(), pre.data(), n);
    for (int t = 0; t < n; t++) {
        uint32_t zw[8], dw[8], rr[8], r2[8], kinv[8], ok;
        fe_set_r2n(r2);
        fn_mont_mul(kinv, &w[8 * t], r2);
        fe_load(zw, z + t, n);
        fe_load(dw, d + t, n);
        for (int j = 0; j < 8; j++) rr[j] = st.r[j * TB + t];
        sign_finish(zw, dw, rr, kinv, s + 8 * t, ok);
        fe_copy(r + 8 * t, rr);
        flags[2 * t] = ok;
        flags[2 * t + 1] = st.grind[t];
    }
    return rounds;
}
extern "C" {
void c_fp_inv(uint32_t *r, const uint32_t *a) { fp_inv(r, a); }
void c_fn_add(uint32_t *r, const uint32_t *a, const uint32_t *b) {
    fn_add(r, a, b);
}
void c_fp_inv_batch(int n, const uint32_t *z, uint32_t *w) {
    std::vector<uint32_t> a(8 * n), pre(8 * n);
    fp_inv_batch(w, z, a.data(), pre.data(), n);
}
// S1 over n keys (8 words each) as one block: the comb a key, one batch
// inversion mod p
void c_fixed_base(int n, const uint32_t *k, const uint32_t *comb,
                  uint32_t *x, uint32_t *y) {
    std::vector<pt> acc(n);
    std::vector<uint32_t> z(8 * n), zi(8 * n), a(8 * n), pre(8 * n);
    for (int i = 0; i < n; i++) {
        comb_mul_one(acc[i], k + 8 * i, comb);
        fe_copy(&z[8 * i], acc[i].z);
    }
    fp_inv_batch(zi.data(), z.data(), a.data(), pre.data(), n);
    for (int i = 0; i < n; i++) {
        fp_mul(x + 8 * i, acc[i].x, &zi[8 * i]);
        fp_mul(y + 8 * i, acc[i].y, &zi[8 * i]);
    }
}
int c_sign(int C, int n, const uint32_t *z, const uint32_t *d,
           const uint32_t *ks, const uint32_t *comb, uint32_t *r,
           uint32_t *s, uint32_t *flags) {
    if (C == 1) return tile<1>(n, z, d, ks, comb, r, s, flags);
    return tile<4>(n, z, d, ks, comb, r, s, flags);
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


def _low(k: int) -> bool:
    """The exact-int rule's test of one candidate: r = x(k*G) mod n is
    below 2^255 and nonzero."""
    pt = jref.point_mul(k, jref.G)
    return not pt.inf and 0 < pt.x % N < 2**255


def _high_nonces(rng, count: int) -> list[int]:
    """`count` random nonces whose r is high (bit 255 set), picked with
    the exact-int oracle."""
    out = []
    while len(out) < count:
        k = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        if not _low(k):
            out.append(k)
    return out


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


@pytest.mark.parametrize("n", [1, 2, 9, 40])
def test_fp_batch_inversion_matches_fp_inv(lib, n):
    """Montgomery's trick mod p (fp_batch_enter, fp_inv_sweep,
    fp_batch_out) against fp_inv element by element: zeros (0 and p) get
    0 and leave the others as they are, values in [p, 2^256) are reduced
    first."""
    rng = np.random.default_rng(64 + n)
    edge = [0, P, 1, P - 1, 2**256 - 1, P + 5, 0, 2**255]
    vals = (edge + [int.from_bytes(rng.bytes(32), "big")
                    for _ in range(n)])[:n]
    if n > 1:
        vals[-1] = 0
    z = np.concatenate([_w8(v) for v in vals])
    w = np.zeros(8 * n, np.uint32)
    lib.c_fp_inv_batch(ctypes.c_int(n), _ptr(z), _ptr(w))
    for i, v in enumerate(vals):
        one = np.zeros(8, np.uint32)
        lib.c_fp_inv(_ptr(one), _ptr(_w8(v % P)))
        assert _int(w[8 * i:8 * i + 8]) == _int(one) == pow(v % P, P - 2, P)


# k = 1, 2^(4j) (every digit 0 but one), n - 1, digits of 0 inside, and
# k = 0 and n (infinity: x = y = 0)
FIXED_KS = [1, 2, 15, 16, 2**4, 2**128, 2**252, 0xF << 252, N - 1, N - 2,
            0x1000000010000001, 2**256 - 1, 0, N]


def test_fixed_base_body_matches_oracle(lib, comb):
    """S1's steps over one block of keys (the comb a key, one batch
    inversion mod p) against ref.point_mul; the infinities in the block
    (k = 0, n) give (0, 0) and leave the others exact."""
    rng = np.random.default_rng(62)
    ks = FIXED_KS + [int.from_bytes(rng.bytes(32), "big") for _ in range(4)]
    n = len(ks)
    kw = np.concatenate([_w8(k) for k in ks])
    x, y = np.zeros(8 * n, np.uint32), np.zeros(8 * n, np.uint32)
    lib.c_fixed_base(ctypes.c_int(n), _ptr(kw), _ptr(comb), _ptr(x), _ptr(y))
    for i, k in enumerate(ks):
        want = jref.point_mul(k, jref.G)
        got = (_int(x[8 * i:8 * i + 8]), _int(y[8 * i:8 * i + 8]))
        assert got == ((0, 0) if want.inf else (want.x, want.y)), hex(k)


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


def _sign(lib, comb, rows, C):
    """The simulated tile on rows [(z, d, candidates)]: a list of (r, s,
    ok, grind), and the rounds it took."""
    n = len(rows)

    def planes(vals):
        return np.stack([_w8(v) for v in vals], axis=1).copy()

    z, d = planes([r[0] for r in rows]), planes([r[1] for r in rows])
    ks = np.concatenate([planes([r[2][c] for r in rows]) for c in range(C)])
    r, s = np.zeros(8 * n, np.uint32), np.zeros(8 * n, np.uint32)
    flags = np.zeros(2 * n, np.uint32)
    rounds = lib.c_sign(ctypes.c_int(C), ctypes.c_int(n), _ptr(z), _ptr(d),
                        _ptr(ks), _ptr(comb), _ptr(r), _ptr(s), _ptr(flags))
    return [(_int(r[8 * i:8 * i + 8]), _int(s[8 * i:8 * i + 8]),
             bool(flags[2 * i]), bool(flags[2 * i + 1]))
            for i in range(n)], rounds


@pytest.mark.parametrize("C", [1, 4])
def test_sign_body_matches_four_candidate_rule(lib, comb, C):
    rows = _sign_rows()
    got, _ = _sign(lib, comb, rows, C)
    grinds = []
    for (z, d, ks), g in zip(rows, got):
        want = E.sign_with_candidates(z, d, ks[:C])
        assert g == want
        grinds.append(want[3])
    if C == 4:
        assert not grinds[0] and all(grinds[1:3])   # h14 has no low R


@pytest.mark.parametrize("n", [7, 13, 24, T])
def test_sign_tile_rounds_match_four_candidate_rule(lib, comb, n):
    """The compacted candidate rounds over a block of T threads: rows whose
    first three candidates have a high r (so they need all four), rows
    with none low among four, k = 0 and n as candidates (r = 0, never
    low), and random rows, against the exact-int rule.  Idle threads take
    pending rows' later candidates, so a tile of n <= T / 4 rows tries all
    its candidates in one round, and no tile takes more than 4."""
    rng = np.random.default_rng(70 + n)

    def rnd():
        return int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1

    rows = []
    for i in range(n):
        if i % 4 == 0:
            ks = _high_nonces(rng, 3) + [rnd()]      # all four needed
        elif i % 7 == 1:
            ks = _high_nonces(rng, 4)                # none low
        elif i % 9 == 2:
            ks = [0, N, rnd(), rnd()]
        else:
            ks = [rnd() for _ in range(4)]
        rows.append((int.from_bytes(rng.bytes(32), "big"), rnd(), ks))
    got, rounds = _sign(lib, comb, rows, 4)
    for (z, d, ks), g in zip(rows, got):
        assert g == E.sign_with_candidates(z, d, ks)
    assert any(not g[3] for g in got) and any(g[3] for g in got)
    assert rounds <= 4
    if 4 * n <= T:
        assert rounds == 1
