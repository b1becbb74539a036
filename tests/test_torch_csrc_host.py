"""The CUDA kernels' arithmetic, compiled for the host.

Every function of lightning_tpu_torch/crypto/csrc/secp256k1.cuh is
__host__ __device__, so the field operations, the batch inversion mod n
and the per-signature bodies of the six kernels (verify_prep_sqrt_one,
build_tables_one with its pt_add_z1, the scan body glv_scan_one<n_g> of
K3 (n_g = 1) and K4 (n_g = 2), the scan body dual_scan_one of K5 and K6)
build with the host C++ compiler too.  Here they run
on the CPU against the exact-int oracle and the port's plain versions,
exactly after normalization.

The header's host pass is its portable C body: the 8x8-word product, the
squaring, the fold mod p and the add / sub chains have a second body in
PTX carry chains for the device pass, and that one is held on the card
only (tests/test_torch_gpu.py, chip_smoke.py), as are the kernels
themselves (grid, shared memory, warp scans, launch).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import ref_python as ref
from lightning_tpu_torch import _build
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import field as F
from lightning_tpu_torch.crypto import hopper_secp as H
from lightning_tpu_torch.crypto import secp256k1 as S

torch.set_num_threads(1)

B = 4
P, N = ref.P, ref.N

SHIM = r"""
#include "secp256k1.cuh"
// A slot for the scan bodies at any step up to SLOT_STEP_MAX.
#define SLOT_STEP_MAX 4
static void put(const pt &acc, uint32_t *out) {
    for (int k = 0; k < 8; k++) {
        out[k] = acc.x[k]; out[8 + k] = acc.y[k]; out[16 + k] = acc.z[k];
    }
}
extern "C" {
void c_verify_prep(const uint32_t *x, const uint32_t *s, uint32_t *y,
                   uint32_t *d, uint32_t *w) {
    uint32_t a[8], pre[8];
    verify_prep_sqrt_one(x, y, d);
    fn_inv_batch(w, s, a, pre, 1);
}
void c_fp_mul(uint32_t *r, const uint32_t *a, const uint32_t *b) { fp_mul(r, a, b); }
void c_fp_sqr(uint32_t *r, const uint32_t *a) { fp_sqr(r, a); }
void c_fp_add(uint32_t *r, const uint32_t *a, const uint32_t *b) { fp_add(r, a, b); }
void c_fp_sub(uint32_t *r, const uint32_t *a, const uint32_t *b) { fp_sub(r, a, b); }
void c_fn_mont_mul(uint32_t *r, const uint32_t *a, const uint32_t *b) {
    fn_mont_mul(r, a, b);
}
void c_fn_mont_sqr(uint32_t *r, const uint32_t *a) { fn_mont_sqr(r, a); }
void c_reduce_once(uint32_t *r, const uint32_t *a, int mod_n) {
    uint32_t m[8];
    if (mod_n) fe_set_n(m); else fe_set_p(m);
    fe_reduce_once(r, a, m);
}
void c_fn_inv_batch(uint32_t *w, const uint32_t *s, uint32_t *a,
                    uint32_t *pre, int T) { fn_inv_batch(w, s, a, pre, T); }
void c_build_tables(const uint32_t *x, const uint32_t *y, uint32_t flip,
                    uint32_t *out) { build_tables_one(x, y, flip, out, 1); }
// p + (qx : qy : 1) by pt_add_z1 (z1 set) or by pt_add with q.z = 1
void c_pt_add_q1(const uint32_t *p, const uint32_t *qx, const uint32_t *qy,
                 int z1, uint32_t *out) {
    pt a, q, r;
    for (int k = 0; k < 8; k++) {
        a.x[k] = p[k]; a.y[k] = p[8 + k]; a.z[k] = p[16 + k];
        q.x[k] = qx[k]; q.y[k] = qy[k];
    }
    fe_set_small(q.z, 1);
    if (z1) pt_add_z1(r, a, qx, qy); else pt_add(r, a, q);
    put(r, out);
}
void c_glv_scan(const int32_t *dl, const int32_t *dh, const int32_t *g,
                const uint32_t *tab, const uint32_t *jt, uint32_t *out,
                int step) {
    pt acc;
    uint32_t slot[GLV_SLOT_WORDS(1) * SLOT_STEP_MAX];
    const glv_fixed<1> fx = {g, jt};
    glv_scan_one<1>(dl, dh, 1, tab, fx, slot, step, acc);
    put(acc, out);
}
void c_glv_scan2(const int32_t *dl, const int32_t *dh, const uint32_t *tab,
                 const uint32_t *g1, const uint32_t *g2, uint32_t *out,
                 int step) {
    pt acc;
    uint32_t slot[GLV_SLOT_WORDS(2) * SLOT_STEP_MAX];
    const glv_fixed<2> fx = {g1, g2};
    glv_scan_one<2>(dl, dh, 1, tab, fx, slot, step, acc);
    put(acc, out);
}
// K5 and K6 through their shared scan body, as thread t = step - 1 of a
// block of `step` threads (its chunks and words lie between the others').
void c_dual_mul_v2(const int32_t *d2, const uint32_t *qtab,
                   const uint32_t *gs, uint32_t *out, int step) {
    pt acc;
    uint32_t slots[DUAL_SLOT_WORDS * SLOT_STEP_MAX];
    const dual_q_table q = {d2, qtab};
    dual_scan_one(q, gs, 1, slots, step - 1, step, acc);
    put(acc, out);
}
void c_dual_mul_planes(const uint32_t *qs, const uint32_t *gs,
                       uint32_t *out, int step) {
    pt acc;
    uint32_t slots[DUAL_SLOT_WORDS * SLOT_STEP_MAX];
    const dual_q_planes q = {qs};
    dual_scan_one(q, gs, 1, slots, step - 1, step, acc);
    put(acc, out);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    out = d / "libshim.so"
    subprocess.run(["c++", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", _build.CRYPTO_CSRC, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _buf(a: np.ndarray, dtype=np.uint32):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def _words(limbs: torch.Tensor) -> np.ndarray:
    """(B, 20) limbs -> (B, 8) uint32 kernel words (after reduction)."""
    return F.to_u32x8(F.normalize(F.FP, limbs)).numpy().T.astype(np.uint32)


def _int(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(words))


def test_verify_prep_body_matches_plain(lib):
    rng = np.random.default_rng(31)
    xs = [int.from_bytes(rng.bytes(32), "big") for _ in range(B - 1)] + [P]
    ss = [int.from_bytes(rng.bytes(32), "big") for _ in range(B - 1)] + [0]
    qx, s = F.from_int_array(xs), F.from_int_array(ss)
    want = H.verify_prep_plain(qx, s)
    x8 = F.to_u32x8(qx).numpy().T.astype(np.uint32)
    s8 = F.to_u32x8(s).numpy().T.astype(np.uint32)
    for i in range(B):
        outs = [np.zeros(8, np.uint32) for _ in range(3)]
        lib.c_verify_prep(_buf(x8[i])[1], _buf(s8[i])[1],
                          *(o.ctypes.data_as(ctypes.c_void_p) for o in outs))
        for o, w, m in zip(outs, want, (P, P, N)):
            assert _int(o) == F.limbs_to_int(w[i]) % m


def test_build_tables_and_scan_bodies_match_plain(lib):
    rng = np.random.default_rng(32)
    pts = [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % (N - 1)
                             + 1) for _ in range(B)]
    u1 = F.from_int_array([int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(B)])
    u2 = F.from_int_array([0] + [int.from_bytes(rng.bytes(32), "big") % N
                                 for _ in range(B - 1)])
    qx = F.from_int_array([p.x for p in pts])
    qy = F.from_int_array([p.y for p in pts])
    d2l, d2h, s2l, s2h, gidx = E.glv_prep_joint(u1, u2)
    byl = torch.where(s2l[:, None], F.sub(F.FP, torch.zeros_like(qy), qy), qy)
    flip = (s2l ^ s2h).to(torch.int64)
    lo, hi = H.build_tables_plain(qx, byl, flip)
    X, Y, Z = H.glv_scan_plain(d2l, d2h, gidx, lo, hi)
    jt = H._joint_table_u32("cpu").numpy().astype(np.uint32)
    bx8, by8 = _words(qx), _words(byl)
    for i in range(B):
        tab = np.zeros((6, 16, 8), np.uint32)
        lib.c_build_tables(_buf(bx8[i])[1], _buf(by8[i])[1],
                           ctypes.c_uint32(int(flip[i])),
                           tab.ctypes.data_as(ctypes.c_void_p))
        for c, coord in enumerate(lo + hi):
            for v in range(16):
                assert _int(tab[c, v]) == F.limbs_to_int(coord[v, i]) % P
        out = np.zeros(24, np.uint32)
        digits = [_buf(t[:, i].numpy(), np.int32) for t in (d2l, d2h, gidx)]
        lib.c_glv_scan(*(p for _, p in digits),
                       tab.ctypes.data_as(ctypes.c_void_p),
                       jt.ctypes.data_as(ctypes.c_void_p),
                       out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1))
        for c, coord in enumerate((X, Y, Z)):
            assert _int(out[8 * c:8 * c + 8]) == F.limbs_to_int(coord[i]) % P


def _scan_inputs(seed, n):
    """n signatures' worth of engine operands: random scalars (u1 = 0 in
    the first), random keys."""
    rng = np.random.default_rng(seed)
    pts = [ref.pubkey_create(int.from_bytes(rng.bytes(32), "big") % (N - 1)
                             + 1) for _ in range(n)]
    u1 = F.from_int_array([0] + [int.from_bytes(rng.bytes(32), "big") % N
                                 for _ in range(n - 1)])
    u2 = F.from_int_array([int.from_bytes(rng.bytes(32), "big") % N
                           for _ in range(n)])
    return (u1, u2, F.from_int_array([p.x for p in pts]),
            F.from_int_array([p.y for p in pts]))


def _col(t: torch.Tensor, i: int):
    """Signature i's slice of a batch-last operand, as a C buffer."""
    dt = np.int32 if t.dtype == torch.int64 else np.uint32
    return _buf(t[..., i].numpy().astype(np.int64).astype(dt), dt)


def _same_point(out, point, i):
    for c, coord in enumerate(point):
        assert _int(out[8 * c:8 * c + 8]) == F.limbs_to_int(coord[i]) % P


# The scan bodies' slot words lie `step` apart (threads a block on the
# card); step 3 also checks that no two words of a slot collide.  K5 runs
# once more with every digit 0 (the table's infinity entry in every
# window) and with every digit 15.
@pytest.mark.parametrize("kernel,step,digit", [
    pytest.param("glv_scan", 1, None, id="glv_scan"),
    pytest.param("glv_scan", 3, None, id="glv_scan-step3"),
    pytest.param("glv_scan2", 1, None, id="glv_scan2"),
    pytest.param("glv_scan2", 3, None, id="glv_scan2-step3"),
    pytest.param("dual_mul_v2", 1, None, id="dual_mul_v2"),
    pytest.param("dual_mul_v2", 3, None, id="dual_mul_v2-step3"),
    pytest.param("dual_mul_v2", 3, 0, id="dual_mul_v2-digit0"),
    pytest.param("dual_mul_v2", 3, 15, id="dual_mul_v2-digit15"),
    pytest.param("dual_mul_planes", 1, None, id="dual_mul_planes"),
    pytest.param("dual_mul_planes", 3, None, id="dual_mul_planes-step3")])
def test_window_scan_bodies_match_plain(lib, kernel, step, digit):
    """K3 and K4 (the GLV scan body at n_g = 1 and 2), K5 and K6 (the
    64-window scan body over a key's table and over Q planes) on the
    operands their engines give them."""
    n = 2
    u1, u2, qx, qy = _scan_inputs(33, n)
    shared = ()
    if kernel.startswith("glv_scan"):
        glv_prep = E.glv_prep_joint if kernel == "glv_scan" else E._glv_prep
        d2l, d2h, s2l, s2h, *fixed = glv_prep(u1, u2)
        qy_neg = F.sub(F.FP, torch.zeros_like(qy), qy)
        byl = torch.where(s2l[:, None], qy_neg, qy)
        lo, hi = H.build_tables_plain(qx, byl, (s2l ^ s2h).to(torch.int64))
        tab = H.tables_to_words(lo, hi)
        if kernel == "glv_scan":
            ops = (d2l, d2h, fixed[0], tab)
            shared = (_buf(H._joint_table_u32("cpu").numpy())[1],)
            want = H.glv_scan_plain(d2l, d2h, fixed[0], lo, hi)
        else:
            ops = (d2l, d2h, tab, *fixed)
            want = H.glv_scan2_plain(d2l, d2h, lo, hi, *fixed)
    else:
        d1, d2 = (E._msb_planes(u, 64) for u in (u1, u2))
        if digit is not None:
            d2 = torch.full_like(d2, digit)
        words = H.to_words(S._build_window(qx, qy))
        gs = E._select_shared_planes(E.shared_words("g", "cpu"), d1)
        if kernel == "dual_mul_v2":
            want = H.dual_mul_v2_plain(d2, words, gs)
            ops = (d2, words.movedim(0, -1), gs)   # signature i: words[i]
        else:
            ops = (E._select_planes(words, d2), gs)
            want = H.dual_mul_planes_plain(*ops)
    for i in range(n):
        out = np.zeros(24, np.uint32)
        bufs = [_col(t, i) for t in ops]
        getattr(lib, "c_" + kernel)(*(p for _, p in bufs), *shared,
                                    out.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.c_int(step))
        _same_point(out, want, i)


def test_pt_add_z1_matches_pt_add(lib):
    """K2's addition of its base (qx : qy : 1) by pt_add_z1 is limb-equal
    to pt_add with q.z = 1: on random coordinates (on the curve or not,
    reduced mod p as K2 reduces its inputs) and on every pair of the
    carry-edge coordinates F.P_EDGES as q (those K2's edge check on the
    card takes), with p's X, Y, Z taken from the same edges."""
    gen = np.random.default_rng(34)
    qs = [(a % P, b % P) for a in F.P_EDGES for b in F.P_EDGES]
    edge = sorted({e % P for e in F.P_EDGES})
    ps = [tuple(edge[(3 * j + c) % len(edge)] for c in (0, 1, 2))
          for j in range(len(qs))]
    rnd = [[int.from_bytes(gen.bytes(32), "big") % P for _ in range(5)]
           for _ in range(40)]
    qs += [tuple(r[:2]) for r in rnd]
    ps += [tuple(r[2:]) for r in rnd]
    for (qx, qy), p in zip(qs, ps):
        pw = np.concatenate([_w8(c) for c in p])
        outs = []
        for z1 in (0, 1):
            out = np.zeros(24, np.uint32)
            lib.c_pt_add_q1(_ptr(pw), _ptr(_w8(qx)), _ptr(_w8(qy)),
                            ctypes.c_int(z1), _ptr(out))
            outs.append(out)
        assert np.array_equal(*outs), (p, qx, qy)


R = 2**256
# Carry edges: 0, 1, m - 1, m - 2, single words of all ones, all ones
# below the modulus' top words, and the top bit alone.
EDGES = [0, 1, 2, 2**32 - 1, 2**64 - 1, 2**224 - 1, 2**255, 2**256 - 2**32]


def _w8(x: int) -> np.ndarray:
    return np.array([(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)],
                    np.uint32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _call(fn, *xs: int) -> int:
    out = np.zeros(8, np.uint32)
    ins = [_w8(x) for x in xs]
    fn(_ptr(out), *map(_ptr, ins))
    return _int(out)


def _operands(mod: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    edge = [v % mod for v in EDGES] + [mod - 1, mod - 2]
    return edge + [int.from_bytes(rng.bytes(32), "big") % mod
                   for _ in range(12)]


def test_fp_ops_match_oracle(lib):
    """The portable product, squaring and branchless add / sub mod p, at
    the carry edges and on random values, against exact ints; the
    squaring also against the product of a value with itself."""
    vals = _operands(P, 51)
    for a in vals:
        sq = _call(lib.c_fp_sqr, a)
        assert sq == a * a % P == _call(lib.c_fp_mul, a, a)
        for b in vals[:12]:
            assert _call(lib.c_fp_mul, a, b) == a * b % P
            assert _call(lib.c_fp_add, a, b) == (a + b) % P
            assert _call(lib.c_fp_sub, a, b) == (a - b) % P
            assert _call(lib.c_fp_sub, b, a) == (b - a) % P


def test_montgomery_ops_match_oracle(lib):
    """Montgomery product and squaring mod n (R = 2^256) at the carry
    edges and on random values: a b / R and a^2 / R mod n."""
    rinv = pow(R, -1, N)
    vals = _operands(N, 52)
    for a in vals:
        sq = _call(lib.c_fn_mont_sqr, a)
        assert sq == a * a * rinv % N == _call(lib.c_fn_mont_mul, a, a)
        for b in vals[:12]:
            assert _call(lib.c_fn_mont_mul, a, b) == a * b * rinv % N


@pytest.mark.parametrize("mod", [P, N], ids=["p", "n"])
def test_reduce_once_at_edges(lib, mod):
    """The branchless a mod m for any 256-bit a, 2^256 - 1 included."""
    for a in (0, 1, mod - 1, mod, mod + 1, 2**255, 2**256 - 1):
        out = np.zeros(8, np.uint32)
        lib.c_reduce_once(_ptr(out), _ptr(_w8(a)), ctypes.c_int(mod == N))
        assert _int(out) == a % mod


@pytest.mark.parametrize("T", [1, 37, 128])
def test_batch_inversion_matches_pow(lib, T):
    """Montgomery's trick over T values, the prep kernel's block
    inversion: w = s^(n-2) mod n for every s of any 256 bits, with 0, n,
    n + 1 and 2^256 - 1 in the array (0 and n give 0)."""
    rng = np.random.default_rng(53 + T)
    edges = [0, N, N + 1, 2**256 - 1]
    if T == 1:
        arrays = [[v] for v in edges]
    else:
        vals = [int.from_bytes(rng.bytes(32), "big") for _ in range(T)]
        for k, v in zip((0, T // 2, T - 2, T - 1), edges):
            vals[k] = v
        arrays = [vals]
    for vals in arrays:
        s = np.concatenate([_w8(v) for v in vals])
        w, a, pre = (np.zeros(8 * T, np.uint32) for _ in range(3))
        lib.c_fn_inv_batch(_ptr(w), _ptr(s), _ptr(a), _ptr(pre),
                           ctypes.c_int(T))
        for i, v in enumerate(vals):
            assert _int(w[8 * i:8 * i + 8]) == pow(v % N, N - 2, N), i


def test_sources_are_the_built_ones():
    for name, (d, src, headers) in _build.KERNELS.items():
        for f in (src, *headers):
            assert os.path.exists(os.path.join(d, f)), name
        assert _build.source_path(name) == os.path.join(d, src)
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_all_compiles_each_source_once(monkeypatch, tmp_path):
    """The build runs one compiler process per source, all at once, keeps
    each ptxas report beside its library and rebuilds only stale ones
    (a stand-in compiler records its calls; no card or nvcc needed)."""
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n'
        'echo "ptxas info    : Used 42 registers, used 0 barriers"\n'
        'echo "    0 bytes stack frame, 0 bytes spill stores"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("NVCC", str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    reports = _build.build_all()
    assert set(reports) == set(_build.SOURCES)
    assert all("Used 42 registers" in r and "spill" in r
               for r in reports.values())
    lines = calls.read_text().splitlines()
    assert len(lines) == len(_build.SOURCES) == 10
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in lines)
    assert _build.build_all() == reports          # nothing stale: no call
    assert len(calls.read_text().splitlines()) == 10


def test_build_rebuilds_only_the_sources_of_a_touched_header(monkeypatch,
                                                             tmp_path):
    """Each source is tied to its own headers: a newer routing.cuh
    rebuilds the two routing kernels and nothing else, a newer
    secp256k1.cuh the eight verify and sign kernels."""
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("NVCC", str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    kernels = {}
    for name, (d, src, headers) in _build.KERNELS.items():
        copy = tmp_path / os.path.basename(d)
        copy.mkdir(exist_ok=True)
        for f in (src, *headers):
            (copy / f).write_text("")
            os.utime(copy / f, (1_000_000, 1_000_000))
        kernels[name] = (str(copy), src, headers)
    monkeypatch.setattr(_build, "KERNELS", kernels)
    _build.build_all()
    for header, want in (("routing.cuh", {"route_sweep", "mcf_ssp"}),
                         ("secp256k1.cuh", set(kernels) - {
                             "route_sweep", "mcf_ssp"})):
        calls.write_text("")
        d = next(d for d, _, hs in kernels.values() if header in hs)
        future = os.path.getmtime(_build._lib_path("mcf_ssp")) + 100
        os.utime(os.path.join(d, header), (future, future))
        _build.build_all()
        built = {os.path.basename(ln.split()[-1])
                 for ln in calls.read_text().splitlines()}
        assert built == {kernels[k][1] for k in want}
        for k in want:   # the stub's libraries are older than the header
            os.utime(_build._lib_path(k), (future + 1, future + 1))
