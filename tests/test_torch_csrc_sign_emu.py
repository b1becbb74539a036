"""The sign kernels' CUDA sources (S1, S2), run on the CPU under a
thread-per-CUDA-thread emulation.

csrc/fixed_base.cu and csrc/ecdsa_sign.cu are compiled by the host C++
compiler against a small header that stands in for CUDA: one std::thread
for each thread of a block (EMU_THREADS a block, the blocks one after
another), __syncthreads
as a barrier of the block, warp shuffles and ballots through a barrier of
the warp, and an occupancy query that reports a card of 2 SMs.  So the
kernels' own block steps run as written: the ballot packing of the
pending rows, the warp scans and sweeps of the batch inversions, the
tiles looping over a grid smaller than the batch, and the launchers'
spreading of rows over the card.  The field arithmetic is the header's
portable host body; its PTX carry chains run only on the card
(tests/test_torch_gpu.py).  Outputs are held against the exact-int
oracle and the four-candidate rule.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess

import numpy as np
import pytest
import torch

from lightning_tpu.crypto import ref_python as jref
from lightning_tpu_torch import _build
from lightning_tpu_torch.crypto import engines as E
from lightning_tpu_torch.crypto import hopper_secp as H

torch.set_num_threads(1)

N = jref.N

FAKE_CUDA = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>
#define __CUDACC__ 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
struct emu_dim { int x = 0; };
inline thread_local emu_dim threadIdx, blockIdx;
inline emu_dim gridDim;
typedef int cudaError_t;
typedef void *cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9,
       cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
namespace emu {
struct warp { std::barrier<> bar{32}; uint32_t slot[32]; };
inline std::barrier<> *block_bar;
inline warp *warps;
inline void launch(int grid, int block, std::function<void()> body) {
    gridDim.x = grid;
    for (int b = 0; b < grid; b++) {
        std::barrier<> bar(block);
        std::vector<warp> ws(block / 32);
        block_bar = &bar;
        warps = ws.data();
        std::vector<std::thread> th;
        for (int t = 0; t < block; t++)
            th.emplace_back([=] { threadIdx.x = t; blockIdx.x = b; body(); });
        for (auto &x : th) x.join();
    }
}
// every lane of the warp passes v; each gets f(lane, slots)
template <class F> inline uint32_t exchange(uint32_t v, F f) {
    const int l = threadIdx.x & 31;
    warp &w = warps[threadIdx.x >> 5];
    w.slot[l] = v;
    w.bar.arrive_and_wait();
    const uint32_t r = f(l, w.slot);
    w.bar.arrive_and_wait();
    return r;
}
}
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
    return emu::exchange(v, [&](int l, uint32_t *s) {
        return l >= d ? s[l - d] : v; });
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) {
    return emu::exchange(v, [&](int l, uint32_t *s) {
        return l + d < 32 ? s[l + d] : v; });
}
inline uint32_t __ballot_sync(unsigned, int pred) {
    return emu::exchange(pred != 0, [](int, uint32_t *s) {
        uint32_t m = 0;
        for (int i = 0; i < 32; i++) m |= s[i] << i;
        return m; });
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline cudaError_t cudaGetDevice(int *d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int *v, int, int) {
    *v = 2;
    return 0;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int *n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaFuncSetAttribute(const void *, int, int) {
    return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
"""


# Threads a block in the emulation, where the card's kernels have 512: 64
# keep the OS threads few (two warps a block, so the block steps still
# cross warps) and make the blocks loop over many tiles.
EMU_THREADS = 64


def _emulated(src: str) -> str:
    """A kernel source for the emulation: fake_cuda.h for the runtime,
    EMU_THREADS threads a block, the dynamic shared table as a static one,
    each <<<grid, block, ...>>>(args) launch as emu::launch."""
    with open(src) as f:
        s = f.read().replace("#include <cuda_runtime.h>",
                             '#include "fake_cuda.h"')
    s = s.replace("extern __shared__ __align__(16) uint32_t table[];",
                  "__shared__ uint32_t table[COMB_TABLE_BYTES / 4];")
    s, n = re.subn(r"^#define (S[12])_THREADS \d+", rf"#define \1_THREADS "
                   rf"{EMU_THREADS}", s, flags=re.M)
    assert n == 1, src
    out, i = [], 0
    for m in re.finditer(r"([\w<>]+)<<<(.*?)>>>\(", s, re.S):
        j, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(s[j], 0)
            j += 1
        grid, block = (x.strip() for x in m.group(2).split(",")[:2])
        out.append(f"{s[i:m.start()]}emu::launch({grid}, {block}, [&] "
                   f"{{ {m.group(1)}({s[m.end():j - 1]}); }})")
        i = j
    return "".join(out) + s[i:]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csrc_sign_emu")
    (d / "fake_cuda.h").write_text(FAKE_CUDA)
    procs = {}
    for k in ("fixed_base", "ecdsa_sign"):
        src = d / f"{k}.cpp"
        src.write_text(_emulated(_build.source_path(k)))
        procs[k] = subprocess.Popen(
            ["c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-fno-gnu-unique", "-Wno-unknown-pragmas", "-I", str(d), "-I",
             _build.CRYPTO_CSRC,
             "-o", str(d / f"lib{k}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for k, p in procs.items():
        out, _ = p.communicate()
        assert p.returncode == 0, out.decode()[-2000:]
    return {k: ctypes.CDLL(str(d / f"lib{k}.so")) for k in procs}


def _planes(vals) -> torch.Tensor:
    """Ints -> (8, n) int32 words, little-endian words, batch fastest."""
    w = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals]
                  for k in range(8)], np.uint32)
    return torch.as_tensor(w.view(np.int32)).contiguous()


def _ints(words: torch.Tensor) -> list[int]:
    w = words.numpy().view(np.uint32)
    return [sum(int(w[k, i]) << (32 * k) for k in range(8))
            for i in range(w.shape[1])]


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("n", [1, 40, 1100])
def test_fixed_base_kernel_emulated_matches_oracle(libs, n):
    """S1 at 1 key, a few keys a block over the 2 blocks, and more keys
    than the 2 blocks hold at once (18 tiles of 64, blocks looping over
    them), with k = 0 and n (infinity) among them; against the oracle on
    every key (on a sample of 100 and the first three at 1,100)."""
    rng = np.random.default_rng(90 + n)
    ks = [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]
    ks[:min(n, 3)] = [2**256 - 1, 0, N][:min(n, 3)]
    k8 = _planes(ks)
    x, y = (torch.empty((8, n), dtype=torch.int32) for _ in range(2))
    assert libs["fixed_base"].fixed_base_launch(
        _p(k8), _p(H._comb_words("cpu")), _p(x), _p(y), ctypes.c_int(n),
        None) == 0
    xs, ys = _ints(x), _ints(y)
    rows = range(n) if n <= 100 else sorted(
        {0, 1, 2, n - 1, *rng.choice(n, 96, replace=False)})
    for i in rows:
        want = jref.point_mul(ks[i], jref.G)
        assert (xs[i], ys[i]) == ((0, 0) if want.inf else (want.x, want.y))


def _high_nonce(rng) -> int:
    while True:
        k = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        if jref.point_mul(k, jref.G).x % N >= 2**255:
            return k


@pytest.mark.parametrize("C,n", [(4, 1), (4, 30), (4, 1100), (1, 300)])
def test_ecdsa_sign_kernel_emulated_matches_rule(libs, C, n):
    """S2: a row alone; 30 rows (15 a block, every candidate in the first
    round); 1,100 rows (18 tiles of up to 64 over 2 blocks, each looping;
    rounds compacted by the ballot); C = 1 at 300.  Rows with no low R among
    four (sha256(b"h14") with the key from b"d14", and rows of high-r
    nonces from the oracle), rows whose first three are high, and k = 0
    and n as candidates, against the exact-int rule on every row (on a
    sample of 120 at 1,100)."""
    rng = np.random.default_rng(95 + n)

    def rnd(m):
        return int.from_bytes(rng.bytes(32), "big") % m

    zs = [rnd(2**256) for _ in range(n)]
    ds = [rnd(N - 1) + 1 for _ in range(n)]
    ks = [[rnd(N - 1) + 1 for _ in range(4)] for _ in range(n)]
    h14 = hashlib.sha256(b"h14").digest()
    zs[0] = int.from_bytes(h14, "big")
    ds[0] = int.from_bytes(hashlib.sha256(b"d14").digest(), "big") \
        % (N - 1) + 1
    ks[0] = E.rfc6979_candidates(h14, ds[0])
    pool = [_high_nonce(rng) for _ in range(8)]
    for i in range(1, n, 5):
        ks[i][:3] = [pool[j] for j in rng.integers(0, 8, 3)]
        if i % 3 == 1:
            ks[i][3] = pool[rng.integers(0, 8)]
    for i in range(2, n, 11):
        ks[i][:2] = [0, N]
    z8, d8 = _planes(zs), _planes(ds)
    ks8 = torch.stack([_planes([k[c] for k in ks]) for c in range(C)])
    r, s = (torch.empty((8, n), dtype=torch.int32) for _ in range(2))
    ok, grind = (torch.empty(n, dtype=torch.uint8) for _ in range(2))
    fn = getattr(libs["ecdsa_sign"], f"ecdsa_sign{C}_launch")
    assert fn(_p(z8), _p(d8), _p(ks8.contiguous()),
              _p(H._comb_words("cpu")), _p(r), _p(s), _p(ok), _p(grind),
              ctypes.c_int(n), None) == 0
    rows = range(n) if n <= 300 else sorted(
        {0, 1, 2, n - 1, *rng.choice(n, 116, replace=False)})
    rr, ss = _ints(r), _ints(s)
    for i in rows:
        assert (rr[i], ss[i], bool(ok[i]), bool(grind[i])) == \
            E.sign_with_candidates(zs[i], ds[i], ks[i][:C]), i
    if C == 4:
        assert not grind[0] and grind.sum() >= n // 2
