"""The routing kernels' per-element arithmetic (routing/csrc/routing.cuh,
``__host__ __device__``) built with the host C++ compiler and held
against the plain PyTorch versions on the CPU: R1's per-edge pricing and
overflow threshold against ``route_sweep_plain``, its division-free
overflow guard against the threshold's division form, R2's
order-preserving key of a double (with -0.0) against torch's float64
minimum.  No card or nvcc needed."""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lightning_tpu_torch import _build
from lightning_tpu_torch.routing import hopper_route as HR

torch.set_num_threads(1)

SHIM = r"""
#include "routing.cuh"
extern "C" {
int64_t c_threshold(int64_t ppm, int64_t cdr) {
    return rt_threshold(ppm, cdr);
}
int c_unsafe(int64_t a, int64_t ppm, int64_t cdr) {
    return rt_unsafe(a, ppm, cdr);
}
int c_price(int64_t d_v, int64_t a_v, int64_t base, int64_t ppm,
            int64_t hmin, int64_t hmax, int64_t cd, int64_t rf,
            int64_t *cand, int64_t *fee, int *ovf) {
    return rt_price(d_v, a_v, 1, base, ppm, hmin, hmax, cd * rf, cand, fee,
                    ovf);
}
uint64_t c_key(double d) { return mcf_key(d); }
double c_unkey(uint64_t k) { return mcf_unkey(k); }
}
"""

I64 = ctypes.c_int64


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("csrc_route")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    out = d / "libshim.so"
    subprocess.run(["c++", "-O1", "-shared", "-fPIC", "-I",
                    _build.ROUTING_CSRC, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    so.c_threshold.argtypes = [I64, I64]
    so.c_threshold.restype = I64
    so.c_unsafe.argtypes = [I64] * 3
    so.c_unsafe.restype = ctypes.c_int
    so.c_price.argtypes = [I64] * 8 + [ctypes.c_void_p] * 3
    so.c_price.restype = ctypes.c_int
    so.c_key.argtypes = [ctypes.c_double]
    so.c_key.restype = ctypes.c_uint64
    so.c_unkey.argtypes = [ctypes.c_uint64]
    so.c_unkey.restype = ctypes.c_double
    return so


def test_threshold_matches_the_plain_ceiling(lib):
    rng = np.random.default_rng(1)
    ppm = np.concatenate([[0, 1, 2, 9999, 1 << 32],
                          rng.integers(0, 10**6, 200)])
    cdr = np.concatenate([[0, 1, 65535 * 10**6, 7, 3],
                          rng.integers(0, 10**10, 200)])
    want = torch.minimum(
        HR.OVF_LIMIT // torch.as_tensor(ppm).clamp(min=1),
        HR.OVF_LIMIT // torch.as_tensor(cdr).clamp(min=1))
    got = [lib.c_threshold(int(p), int(c)) for p, c in zip(ppm, cdr)]
    assert got == want.tolist()


def test_overflow_guard_matches_the_division_form(lib):
    """rt_unsafe (128-bit products, no division) decides a >
    rt_threshold(ppm, cdr) exactly: on the edges of both forms and on
    10,000 seeded random triples."""
    ppms = [0, 1, 2, 10**6, (1 << 61) - 1, 1 << 61, 1 << 62]
    cdrs = [0, 1, HR.RISK_DENOM, 1 << 40]
    triples = []
    for p in ppms:
        for c in cdrs:
            thr = lib.c_threshold(p, c)
            triples += [(a, p, c) for a in (0, thr - 1, thr, thr + 1,
                                            1 << 62)]
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 63, (10_000, 3))
    vals = rng.integers(0, 1 << 62, (10_000, 3)) >> bits
    triples += [tuple(int(x) for x in t) for t in vals]
    got = [lib.c_unsafe(a, p, c) for a, p, c in triples]
    want = [int(a > lib.c_threshold(p, c)) for a, p, c in triples]
    assert got == want
    assert 0 < sum(got) < len(got)


def test_edge_price_matches_route_sweep_plain(lib):
    """E edges u_i -> 0, each query i routing from u_i to node 0 over
    one sweep: the plain version's label at u_i is edge i's candidate
    cost for query i, and its overflow flag the OR over the edges that
    query prices.  Amounts, riskfactors and HTLC windows straddle every
    test, the overflow guard included."""
    rng = np.random.default_rng(7)
    E = 96
    n = E + 1
    src = np.arange(1, n, dtype=np.int32)
    dst = np.zeros(E, np.int32)
    base = rng.integers(0, 5000, E).astype(np.int64)
    ppm = rng.choice([0, 1, 500, 9999, 10**6], E).astype(np.int64)
    cd = rng.choice([0, 6, 144, 65535], E).astype(np.int64)
    hmin = rng.choice([0, 0, 50_000, 1 << 40], E).astype(np.int64)
    hmax = rng.choice([0, 0, 80_000, 1 << 45], E).astype(np.int64)
    amount = rng.choice([0, 1_000, 60_000, 10**7, 1 << 40, 1 << 47, 1 << 48],
                        E).astype(np.int64)
    rf = rng.choice([0, 1, 10, 10**6], E).astype(np.int64)
    ok = rng.random((E, E)) < 0.9
    cltv = np.full(E, 18, np.int64)
    dist, _, ovf = HR.route_sweep_plain(
        *(torch.as_tensor(a) for a in (src, dst, base, ppm, cd, hmin, hmax,
                                       ok, src, dst, amount, cltv, rf)),
        n, 1)
    cand, fee, flag = I64(), I64(), ctypes.c_int()
    n_ok = n_ovf = 0
    for q in range(E):
        want_ovf = False
        for e in range(E):
            flag.value = 0
            r = lib.c_price(0, int(amount[q]), int(base[e]), int(ppm[e]),
                            int(hmin[e]), int(hmax[e]), int(cd[e]),
                            int(rf[q]), ctypes.byref(cand),
                            ctypes.byref(fee), ctypes.byref(flag))
            want_ovf |= bool(flag.value) and bool(ok[q, e])
            if e == q:
                got = cand.value if r and ok[q, e] else HR.INF_COST
                assert got == int(dist[q]), (q, r, flag.value)
                n_ok += bool(r and ok[q, e])
        assert want_ovf == bool(ovf[q]), q
        n_ovf += want_ovf
    assert 0 < n_ok < E and 0 < n_ovf < E


def test_double_key_orders_like_float64_min(lib):
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        [0.0, -0.0, np.inf, -np.inf, 1e-300, -1e-300, 5e-324, -5e-324,
         1.0, -1.0, 1e-9, 1.0 + 2**-52, np.finfo(np.float64).max,
         -np.finfo(np.float64).max],
        rng.normal(0, 1e6, 300), rng.choice([0.0, -0.0, 3.0], 50)])
    keys = np.array([lib.c_key(float(v)) for v in vals], np.uint64)
    assert lib.c_key(-0.0) == lib.c_key(0.0)
    for v, k in zip(vals, keys):
        back = lib.c_unkey(int(k))
        assert back == v and (v != 0.0 or np.signbit(back) == 0)
    # order: a < b as doubles iff key(a) < key(b) (and equal iff equal)
    i, j = rng.integers(0, len(vals), (2, 4000))
    assert np.array_equal(vals[i] < vals[j], keys[i] < keys[j])
    assert np.array_equal(vals[i] == vals[j], keys[i] == keys[j])
    # a segment minimum by keys is torch's float64 minimum
    seg = rng.integers(0, 16, len(vals))
    want = torch.full((16,), torch.inf, dtype=torch.float64).scatter_reduce(
        0, torch.as_tensor(seg), torch.as_tensor(vals), "amin")
    for s in range(16):
        ks = keys[seg == s]
        got = lib.c_unkey(int(ks.min())) if len(ks) else np.inf
        assert got == float(want[s])
