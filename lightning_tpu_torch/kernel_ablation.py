"""The kernel redesigns on the card, each step timed against the one
before it in one process.

    python -m lightning_tpu_torch.kernel_ablation --parent DIR
        [--bucket 65536] [--out FILE]

DIR holds an earlier commit's ``crypto/csrc`` (the header and the six
sources), unpacked outside git, for example

    git archive <commit> lightning_tpu_torch/crypto/csrc \\
        | tar -x -C lightning_tpu_torch/_build/parent

Variants, each built with ``_build.NVCC_FLAGS`` (one nvcc process each,
all at once):

* K3 ``glv_scan``: ``parent`` (DIR's source and header); ``field`` (the
  parent's window loop, which reads a window's entries after its
  doublings, over this tree's field layer, 128 threads, no launch
  bounds); ``bounds`` (``field`` with ``__launch_bounds__(128, 4)``);
  ``prefetch`` (this tree's source: the cp.async slot, 256 threads a
  block); ``prefetch64`` and ``prefetch128`` (the same at 64 and 128
  threads a block);
* K1 ``verify_prep``: ``parent``; ``chain`` (this tree's field layer, a
  Fermat chain per thread); ``warp0`` (the batch inversion over 128
  signatures with the chain on signature warp 0, which takes its square
  roots after it); ``batch128`` (the chain on a warp of its own, 128
  signatures a block); ``batch`` (this tree's source, 256); ``batch512``;
* K2, K4, K5, K6: ``parent`` and ``new`` (this tree's source).

Every variant's outputs must equal this tree's kernel's on the same
random inputs at B = bucket (the script fails otherwise).  Then each is
timed with CUDA events (20 calls after 2 warm-up calls) in the order of
its steps and back again (a b c c b a), so a drift of the card's clock
shows as a difference between a variant's two readings; K3's variants
also with every digit and joint index one fixed value.  Prints one line
per reading and the ptxas report of every variant, and writes all of it,
with the card's name and power limit, to FILE as JSON if --out is given.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .crypto import _build
from .crypto import hopper_secp as H

REPS, WARM = 20, 2

# The parent's K3 window loop over this tree's header; BOUNDS becomes the
# variant's launch bounds.
K3_OLD_LOOP = r"""
#include <cuda_runtime.h>
#include "secp256k1.cuh"
__device__ __forceinline__ void joint_load(pt &o, const uint32_t *jt, int g) {
    const uint32_t *b = jt + g * 24;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        o.x[k] = __ldg(b + k);
        o.y[k] = __ldg(b + 8 + k);
        o.z[k] = __ldg(b + 16 + k);
    }
}
__global__ void BOUNDS glv_scan_kernel(
        const int32_t *__restrict__ d2l, const int32_t *__restrict__ d2h,
        const int32_t *__restrict__ gidx, const uint32_t *__restrict__ tab,
        const uint32_t *__restrict__ jt, uint32_t *__restrict__ ox,
        uint32_t *__restrict__ oy, uint32_t *__restrict__ oz, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const long long st = B;
    pt acc, q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < GLV_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        tab_load(q, tab + i, st, 0, d2l[w * st + i] & 15);
        pt_add(acc, acc, q);
        tab_load(q, tab + i, st, 1, d2h[w * st + i] & 15);
        pt_add(acc, acc, q);
        joint_load(q, jt, gidx[w * st + i] & 1023);
        pt_add(acc, acc, q);
    }
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}
extern "C" int glv_scan_launch(const void *d2l, const void *d2h,
                               const void *gidx, const void *tab,
                               const void *jt, void *x, void *y, void *z,
                               int B, void *stream) {
    if (B <= 0) return 0;
    glv_scan_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)d2l, (const int32_t *)d2h, (const int32_t *)gidx,
        (const uint32_t *)tab, (const uint32_t *)jt, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}
"""

# K1 with a Fermat chain per thread over this tree's header.
K1_CHAIN = r"""
#include <cuda_runtime.h>
#include "secp256k1.cuh"
__global__ void verify_prep_kernel(
        const uint32_t *__restrict__ qx, const uint32_t *__restrict__ s,
        uint32_t *__restrict__ oy, uint32_t *__restrict__ od,
        uint32_t *__restrict__ ow, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    uint32_t x[8], sv[8], y[8], d[8], a[8], w[8], one[8];
    fe_load(x, qx + i, B);
    fe_load(sv, s + i, B);
    verify_prep_sqrt_one(x, y, d);
    uint32_t z = fn_batch_enter(a, sv);
    fn_inv_mont(w, a);
    fe_set_small(one, 1);
    fn_batch_out(w, w, one, z);
    fe_store(oy + i, B, y);
    fe_store(od + i, B, d);
    fe_store(ow + i, B, w);
}
extern "C" int verify_prep_launch(const void *qx, const void *s, void *y,
                                  void *d, void *w, int B, void *stream) {
    if (B <= 0) return 0;
    verify_prep_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)qx, (const uint32_t *)s, (uint32_t *)y,
        (uint32_t *)d, (uint32_t *)w, B);
    return (int)cudaGetLastError();
}
"""

# K1's batch inversion with the chain on signature warp 0, which takes its
# own square roots after the chain, over this tree's header.
K1_WARP0 = r"""
#include <cuda_runtime.h>
#include "secp256k1.cuh"
#define PREP_WARPS 4
__device__ __forceinline__ void sqrt_store(const uint32_t *qx, uint32_t *oy,
                                           uint32_t *od, int i, int B) {
    uint32_t x[8], y[8], d[8];
    fe_load(x, qx + i, B);
    verify_prep_sqrt_one(x, y, d);
    fe_store(oy + i, B, y);
    fe_store(od + i, B, d);
}
__global__ void __launch_bounds__(128) verify_prep_kernel(
        const uint32_t *__restrict__ qx, const uint32_t *__restrict__ s,
        uint32_t *__restrict__ oy, uint32_t *__restrict__ od,
        uint32_t *__restrict__ ow, int B) {
    __shared__ uint32_t warp_prod[32], warp_inv[32], scratch[32];
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    const int i = blockIdx.x * 128 + t;
    const bool live = i < B;
    uint32_t sv[8], pre[8], suf[8], up[8], dn[8], x[8];
    if (live) fe_load(sv, s + i, B); else fe_set_small(sv, 1);
    const uint32_t zero = fn_batch_enter(pre, sv);
    fe_copy(suf, pre);
#pragma unroll 1
    for (int dist = 1; dist < 32; dist <<= 1) {
        for (int k = 0; k < 8; k++) {
            up[k] = __shfl_up_sync(0xFFFFFFFFu, pre[k], dist);
            dn[k] = __shfl_down_sync(0xFFFFFFFFu, suf[k], dist);
        }
        if (lane >= dist) fn_mont_mul(pre, up, pre);
        if (lane + dist < 32) fn_mont_mul(suf, suf, dn);
    }
    if (lane == 31) fe_copy(warp_prod + 8 * wid, pre);
    for (int k = 0; k < 8; k++) {
        up[k] = __shfl_up_sync(0xFFFFFFFFu, pre[k], 1);
        dn[k] = __shfl_down_sync(0xFFFFFFFFu, suf[k], 1);
    }
    if (lane == 0) fe_set_rn(up);
    if (lane == 31) fe_set_rn(dn);
    fn_mont_mul(x, up, dn);
    __syncthreads();
    if (t == 0) fn_inv_sweep(warp_inv, warp_prod, scratch, PREP_WARPS);
    else if (wid != 0 && live) sqrt_store(qx, oy, od, i, B);
    __syncthreads();
    if (wid == 0 && live) sqrt_store(qx, oy, od, i, B);
    if (live) {
        uint32_t w[8];
        fn_batch_out(w, x, warp_inv + 8 * wid, zero);
        fe_store(ow + i, B, w);
    }
}
extern "C" int verify_prep_launch(const void *qx, const void *s, void *y,
                                  void *d, void *w, int B, void *stream) {
    if (B <= 0) return 0;
    verify_prep_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)qx, (const uint32_t *)s, (uint32_t *)y,
        (uint32_t *)d, (uint32_t *)w, B);
    return (int)cudaGetLastError();
}
"""


def variants(parent: str) -> dict[str, dict[str, tuple]]:
    """kernel -> variant -> (source path or text, include dir), in the
    order of the steps."""
    here = _build.CSRC

    def own(k):
        return os.path.join(here, _build.SOURCES[k])

    def threads(k, macro, n):
        with open(own(k)) as f:
            src = f.read()
        return re.sub(rf"#define {macro} \d+", f"#define {macro} {n}", src)

    def old(k):
        return os.path.join(parent, _build.SOURCES[k])

    out = {
        "glv_scan": {
            "parent": (old("glv_scan"), parent),
            "field": (K3_OLD_LOOP.replace("BOUNDS", ""), here),
            "bounds": (K3_OLD_LOOP.replace("BOUNDS",
                                           "__launch_bounds__(128, 4)"),
                       here),
            "prefetch": (own("glv_scan"), here),
            "prefetch64": (threads("glv_scan", "GLV_THREADS", 64), here),
            "prefetch128": (threads("glv_scan", "GLV_THREADS", 128), here),
        },
        "verify_prep": {
            "parent": (old("verify_prep"), parent),
            "chain": (K1_CHAIN, here),
            "warp0": (K1_WARP0, here),
            "batch128": (threads("verify_prep", "PREP_THREADS", 128), here),
            "batch": (own("verify_prep"), here),
            "batch512": (threads("verify_prep", "PREP_THREADS", 512), here),
        },
    }
    for k in ("build_tables", "glv_scan2", "dual_mul_v2", "dual_mul_planes"):
        out[k] = {"parent": (old(k), parent), "new": (own(k), here)}
    return out


def build(table, outdir: str) -> dict[str, dict[str, tuple]]:
    """Compile every variant at once; returns kernel -> variant ->
    (loaded library, ptxas report)."""
    os.makedirs(outdir, exist_ok=True)
    exe, procs = _build.nvcc(), {}
    for k, vs in table.items():
        for v, (src, inc) in vs.items():
            if not os.path.exists(src):
                path = os.path.join(outdir, f"{k}_{v}.cu")
                with open(path, "w") as f:
                    f.write(src)
                src = path
            lib = os.path.join(outdir, f"lib{k}_{v}.so")
            cmd = [exe, *_build.NVCC_FLAGS, "-I", inc, "-o", lib, src]
            procs[k, v] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    built: dict[str, dict[str, tuple]] = {}
    failed = []
    for (k, v), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k}/{v}:\n{out}")
            continue
        report = " | ".join(ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln)
        built.setdefault(k, {})[v] = (ctypes.CDLL(lib), report)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def launcher(lib: ctypes.CDLL, kernel: str, args: list, B: int):
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int,
                                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args]

    def run():
        rc = fn(*ptrs, B, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    return run


def time_ms(run) -> float:
    for _ in range(WARM):
        run()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(REPS):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def inputs(B: int, dev) -> dict[str, tuple[list, list]]:
    """kernel -> (input tensors, output tensors) at size B, random
    canonical words (< 2^255, below p and n) from seed 11; K3 and K4 read
    tables built by this tree's K2."""
    gen = np.random.default_rng(11)

    def words(*shape):
        w = gen.integers(0, 2**32, (*shape, 8, B), dtype=np.uint32)
        w[..., 7, :] &= 0x7FFFFFFF
        return torch.as_tensor(w.view(np.int32), device=dev)

    def digits(n, top):
        return torch.as_tensor(gen.integers(0, top, (n, B), dtype=np.int32),
                               device=dev)

    def out(*shape):
        return torch.empty((*shape, B), dtype=torch.int32, device=dev)

    bx, by = words(), words()
    flip = digits(1, 2)[0].contiguous()
    tab = out(6, 16, 8)
    H._launch("build_tables", bx, by, flip, tab, B=B)
    d2l, d2h, gidx = digits(33, 16), digits(33, 16), digits(33, 1024)
    jt = H._joint_table_u32(str(dev))
    pts = [out(8) for _ in range(3)]
    return {
        "verify_prep": ([words(), words()], [out(8) for _ in range(3)]),
        "build_tables": ([bx, by, flip], [out(6, 16, 8)]),
        "glv_scan": ([d2l, d2h, gidx, tab, jt], pts),
        "glv_scan2": ([d2l, d2h, tab, words(33, 3), words(33, 3)], pts),
        "dual_mul_v2": ([digits(64, 16), words(16, 3), words(64, 3)], pts),
        "dual_mul_planes": ([words(64, 3), words(64, 3)], pts),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier commit's crypto/csrc directory")
    ap.add_argument("--bucket", type=int, default=65536)
    ap.add_argument("--out", help="write the whole record here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev, B = torch.device("cuda"), args.bucket
    _build.build_all()
    built = build(variants(os.path.abspath(args.parent)),
                  os.path.join(_build.BUILD_DIR, "ablation"))
    record = {"card": card, "B": B, "reps": REPS, "ptxas": {}, "ms": {},
              "fixed_digits_ms": {}}
    for k, vs in built.items():
        for v, (lib, rep) in vs.items():
            if hasattr(lib, "glv_scan_blocks_per_sm"):
                rep += f" | {lib.glv_scan_blocks_per_sm()} blocks per SM"
            record["ptxas"][f"{k}/{v}"] = rep
            print(f"ptxas {k}/{v}: {rep}", flush=True)
    data = inputs(B, dev)
    for k, vs in built.items():
        ins, outs = data[k]
        want = [torch.empty_like(o) for o in outs]
        launcher(_build.lib(k), k, ins + want, B)()
        runs = {v: launcher(lib, k, ins + outs, B) for v, (lib, _) in
                vs.items()}
        for v, run in runs.items():
            for o in outs:
                o.fill_(-1)
            run()
            torch.cuda.synchronize()
            assert all(torch.equal(o, w) for o, w in zip(outs, want)), \
                f"{k}/{v} disagrees with this tree's kernel"
        steps = list(runs)
        if k == "glv_scan":
            main_steps = ["parent", "field", "bounds", "prefetch"]
            orders = [main_steps, ["prefetch", "prefetch64", "prefetch128"]]
        else:
            orders = [steps]
        record["ms"][k] = {v: [] for v in steps}
        for order in orders:
            for v in order + order[::-1]:
                ms = time_ms(runs[v])
                record["ms"][k][v].append(ms)
                print(f"time {k}/{v}: {ms:.4f} ms/call at B={B}", flush=True)
        if k == "glv_scan":
            fixed = [torch.full_like(t, 5) for t in ins[:3]]
            frun = {v: launcher(lib, k, fixed + ins[3:] + outs, B)
                    for v, (lib, _) in vs.items()}
            for v in main_steps + main_steps[::-1]:
                ms = time_ms(frun[v])
                record["fixed_digits_ms"].setdefault(v, []).append(ms)
                print(f"time {k}/{v} fixed digits: {ms:.4f} ms/call",
                      flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"ablation": record["ms"],
                      "fixed_digits_ms": record["fixed_digits_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
