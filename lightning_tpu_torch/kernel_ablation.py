"""The kernel redesigns on the card, each step timed against the one
before it in one process.

    python -m lightning_tpu_torch.kernel_ablation --parent DIR
        [--bucket 65536] [--out FILE]

DIR holds an earlier commit's ``crypto/csrc`` (the header and the six
sources), unpacked outside git, for example

    git archive <commit> lightning_tpu_torch/crypto/csrc \\
        | tar -x -C lightning_tpu_torch/_build/parent

Variants, each built with ``_build.NVCC_FLAGS`` (one nvcc process each,
all at once), in the order of their steps:

* K2 ``build_tables``: ``parent`` (DIR's source and header); ``z1``
  (this tree's source, where every addition is ``pt_add_z1``, at the
  parent's launch: 128 threads a block, no launch bounds); ``z1_64``
  (this tree's launch) and ``z1_32``; launch bounds of (threads a
  block, blocks an SM) ``b256x2`` and ``b128x4`` (128 registers a
  thread) and ``b128x3`` (168);
* K4 ``glv_scan2``: ``parent``; ``bounds`` (the parent's window loop,
  which reads a window's points after its doublings, over this tree's
  header at K3's launch: 256 threads, ``__launch_bounds__(256, 2)``);
  ``prefetch`` (this tree's source: K3's cp.async slot through the scan
  body K3 and K4 share, 256 threads); ``prefetch128`` (the same at 128
  threads and 4 blocks an SM);
* K3 ``glv_scan`` (the shared body at n_g = 1), K1 ``verify_prep``, K5
  ``dual_mul_v2``, K6 ``dual_mul_planes``: ``parent`` and ``new`` (this
  tree's source).

Every variant's outputs must equal this tree's kernel's on the same
random inputs at B = bucket (the script fails otherwise).  Then each is
timed with CUDA events (20 calls after 2 warm-up calls) in the order of
its steps and back again (a b c c b a), so a drift of the card's clock
shows as a difference between a variant's two readings; K3's and K4's
variants also with every digit and joint index one fixed value, so the
difference is what their gathers cost.  Prints one line per reading and
the ptxas report of every variant (with its blocks per SM where the
library reports them), names the variant each kernel ships, and writes
all of it, with the card's name and power limit, to FILE as JSON if
--out is given.  Needs a CUDA device and nvcc.
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

# The parent's K4 window loop over this tree's header, at K3's launch.
K4_OLD_LOOP = r"""
#include <cuda_runtime.h>
#include "secp256k1.cuh"
__device__ __forceinline__ void tab_load(pt &o, const uint32_t *tab,
                                         long long stride, int half, int v) {
    const long long plane = (long long)16 * 8 * stride;
    const uint32_t *b = tab + (long long)((3 * half * 16 + v) * 8) * stride;
    fe_load(o.x, b, stride);
    fe_load(o.y, b + plane, stride);
    fe_load(o.z, b + 2 * plane, stride);
}
__global__ void __launch_bounds__(256, 2) glv_scan2_kernel(
        const int32_t *__restrict__ d2l, const int32_t *__restrict__ d2h,
        const uint32_t *__restrict__ tab, const uint32_t *__restrict__ g1,
        const uint32_t *__restrict__ g2, uint32_t *__restrict__ ox,
        uint32_t *__restrict__ oy, uint32_t *__restrict__ oz, int B) {
    int i = blockIdx.x * 256 + threadIdx.x;
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
        plane_load(q, g1 + i, st, w);
        pt_add(acc, acc, q);
        plane_load(q, g2 + i, st, w);
        pt_add(acc, acc, q);
    }
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}
extern "C" int glv_scan2_launch(const void *d2l, const void *d2h,
                                const void *tab, const void *g1,
                                const void *g2, void *x, void *y, void *z,
                                int B, void *stream) {
    if (B <= 0) return 0;
    glv_scan2_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t *)d2l, (const int32_t *)d2h, (const uint32_t *)tab,
        (const uint32_t *)g1, (const uint32_t *)g2, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}
"""

# K3 and K4 are also timed with fixed digits (their first n inputs).
FIXED_INPUTS = {"glv_scan": 3, "glv_scan2": 2}
# Timing orders beyond "every step, and back".
ORDERS = {"glv_scan2": [["parent", "bounds", "prefetch"],
                        ["prefetch", "prefetch128"]]}


def variants(parent: str) -> dict[str, dict[str, tuple]]:
    """kernel -> variant -> (source path or text, include dir), in the
    order of the steps."""
    here = _build.CSRC

    def own(k):
        return os.path.join(here, _build.SOURCES[k])

    def subst(k, bounds=None, **defines):
        """This tree's source of k with each ``#define NAME ...`` line
        of `defines` set to its value and, if `bounds` is given, its
        kernel under ``__launch_bounds__(*bounds)`` (text, since nvcc's
        -D would split the value at its comma)."""
        with open(own(k)) as f:
            src = f.read()
        for name, val in defines.items():
            src, n = re.subn(rf"#define {name}\b.*", f"#define {name} {val}",
                             src)
            assert n == 1, f"{k}: no #define {name}"
        if bounds:
            head = f"__global__ void\n{k}_kernel("
            assert head in src, f"{k}: no kernel head to bound"
            src = src.replace(head, "__global__ void __launch_bounds__"
                              f"({bounds[0]}, {bounds[1]})\n{k}_kernel(")
        return src

    def old(k):
        return os.path.join(parent, _build.SOURCES[k])

    out = {
        "build_tables": {
            "parent": (old("build_tables"), parent),
            **{f"z1{s}": (subst("build_tables", K2_THREADS=t), here)
               for s, t in (("", 128), ("_64", 64), ("_32", 32))},
            **{f"b{t}x{n}": (subst("build_tables", (t, n), K2_THREADS=t),
                             here) for t, n in ((256, 2), (128, 4), (128, 3))},
        },
        "glv_scan2": {
            "parent": (old("glv_scan2"), parent),
            "bounds": (K4_OLD_LOOP, here),
            "prefetch": (own("glv_scan2"), here),
            "prefetch128": (subst("glv_scan2", GLV_THREADS=128), here),
        },
    }
    for k in ("glv_scan", "verify_prep", "dual_mul_v2", "dual_mul_planes"):
        out[k] = {"parent": (old(k), parent), "new": (own(k), here)}
    return out


def shipped(table) -> dict[str, str]:
    """kernel -> the variant whose source is this tree's."""
    out = {}
    for k, vs in table.items():
        with open(os.path.join(_build.CSRC, _build.SOURCES[k])) as f:
            mine = f.read()
        for v, (src, inc) in vs.items():
            text = src
            if os.path.exists(src):
                with open(src) as f:
                    text = f.read()
            if inc == _build.CSRC and text == mine:
                out[k] = v
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
    table = variants(os.path.abspath(args.parent))
    built = build(table, os.path.join(_build.BUILD_DIR, "ablation"))
    record = {"card": card, "B": B, "reps": REPS, "shipped": shipped(table),
              "ptxas": {}, "ms": {}, "fixed_digits_ms": {}}
    print(f"shipped: {json.dumps(record['shipped'])}", flush=True)
    for k, vs in built.items():
        for v, (lib, rep) in vs.items():
            if hasattr(lib, f"{k}_blocks_per_sm"):
                n = getattr(lib, f"{k}_blocks_per_sm")()
                rep += f" | {n} blocks per SM"
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
        record["ms"][k] = {v: [] for v in steps}
        for order in ORDERS.get(k, [steps]):
            for v in order + order[::-1]:
                ms = time_ms(runs[v])
                record["ms"][k][v].append(ms)
                print(f"time {k}/{v}: {ms:.4f} ms/call at B={B}", flush=True)
        if k in FIXED_INPUTS:
            n = FIXED_INPUTS[k]
            fixed = [torch.full_like(t, 5) for t in ins[:n]]
            frun = {v: launcher(lib, k, fixed + ins[n:] + outs, B)
                    for v, (lib, _) in vs.items()}
            record["fixed_digits_ms"][k] = {v: [] for v in steps}
            for v in steps + steps[::-1]:
                ms = time_ms(frun[v])
                record["fixed_digits_ms"][k][v].append(ms)
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
