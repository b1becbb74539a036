"""The routing kernels' redesign on the card, against the commit before
it, in one process.

    python -m lightning_tpu_torch.routing_ablation --parent DIR
        [--seed 7] [--channels 100000] [--nodes 12500] [--out FILE]

DIR holds an earlier commit's ``routing/csrc`` (``route_sweep.cu``,
``mcf_ssp.cu`` and ``routing.cuh``), unpacked outside git, for example

    git archive <commit> lightning_tpu_torch/routing/csrc \\
        | tar -x -C lightning_tpu_torch/_build/parent

Variants, built as ``kernel_ablation.build`` builds its own (one nvcc
process each, all at once):

* R1 ``route_sweep``: ``parent`` (DIR's kernel: a 1,024-thread block a
  query, every edge priced twice in each of the 20 sweeps); ``w512``
  (this tree's source at 512 threads a block); ``w1024`` (this tree's
  source as it ships, 1,024 threads a block);
* R2 ``mcf_ssp``: ``parent`` (DIR's kernel, a 1,024-thread block a
  query); ``new`` (this tree's source: the node entries in the blocks'
  shared memory where they fit, as the wrapper decides); ``global``
  (this tree's source with the entries always in global memory, timed
  at the sizes where ``new`` shares them).

Phase 7's shapes (``chip_smoke.py``): a synthetic graph of `channels`
channels and `nodes` nodes made on the card from `seed`, R1 on 64
queries of ``bench.py route``'s mix (random pairs from rng 11, 1,000,000
msat), R2 on 8 of ``bench.py mcf``'s (rng 13, 100,000 to 50,000,000
msat, 8 parts).  Every variant, this tree's at every cluster size, must
equal the plain version (the script fails otherwise).
Then each is timed with CUDA events (20 calls after 2 warm-ups) through
a wrapper that allocates as the shipped one does, in order and back
again (a b c c b a), so a drift of the card's clock shows as a
difference between a variant's two readings.  First, DSM_MIN_PROBE
checks the 64-bit minimum the kernels fold into another block's shared
memory (cluster.cuh cas_min) against atomicMin.  Prints one line a reading,
each variant's ptxas report with its SASS instructions and CALLs (a
call of the int64 division routine is one), and writes all of it, with
the card's name and power limit, to FILE as JSON if --out is given.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import _build
from .gossip import gossmap, store, synth
from .kernel_ablation import build, time_ms
from .routing import device as RD
from .routing import hopper_route as HR
from .routing import mcf_device as MD
from .routing.planes import RoutePlanes

# Why cluster.cuh folds 64-bit minima into another block's shared memory
# by compare-and-swap: a cluster of two blocks, four warps of block 0
# folding 128 values into 8 words of block 1's shared memory (16 lanes a
# word), by atomicMin on 64 and on 32 bits and by cas_min.  Each word
# must be read at its initial value by exactly one lane, and end at the
# least value folded into it.
DSM_MIN_PROBE = r"""
#include <cuda_runtime.h>
#include "cluster.cuh"
#define MAX64 0x7fffffffffffffffLL
__global__ void __cluster_dims__(2, 1, 1) probe(long long *out) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = cl.block_rank(), tid = threadIdx.x;
    __shared__ int64_t a[3][8];
    __shared__ int32_t b[8];
    __shared__ int first[4];
    if (tid < 8) {
        a[0][tid] = a[1][tid] = a[2][tid] = MAX64;
        b[tid] = 0x7fffffff;
    }
    if (tid < 4) first[tid] = 0;
    cl.sync();
    if (rank == 0 && tid < 128) {
        const int w = tid & 7, v = tid + 5;
        int *f = sh_of(first, 1);
        if (atomicMin((long long *)sh_of(&a[0][w], 1), v) == MAX64)
            atomicAdd(f, 1);
        if (cas_min(sh_of(&a[1][w], 1), (int64_t)v) == MAX64)
            atomicAdd(f + 1, 1);
        if (atomicMin(sh_of(&b[w], 1), v) == 0x7fffffff)
            atomicAdd(f + 2, 1);
    }
    cl.sync();
    if (rank == 1 && tid == 0) {
        for (int i = 0; i < 3; ++i) out[i] = first[i];
        for (int w = 0; w < 8; ++w) {
            out[3 + w] = a[0][w];
            out[11 + w] = a[1][w];
            out[19 + w] = b[w];
        }
    }
    cl.sync();
}
extern "C" int probe_launch(void *out) {
    probe<<<2, 256>>>((long long *)out);
    return (int)cudaDeviceSynchronize();
}
"""


def dsm_min_probe(outdir: str) -> dict:
    """Run DSM_MIN_PROBE: for atomicMin on 64 bits, cas_min and
    atomicMin on 32 bits, the lanes that read a word's initial value (8
    is right) and whether every word ends at its least value."""
    src = os.path.join(outdir, "dsm_min_probe.cu")
    lib = os.path.join(outdir, "libdsm_min_probe.so")
    with open(src, "w") as f:
        f.write(DSM_MIN_PROBE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.ROUTING_CSRC, "-o", lib, src], check=True,
                   capture_output=True)
    out = torch.zeros(27, dtype=torch.int64, device="cuda")
    fn = ctypes.CDLL(lib).probe_launch
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(out.data_ptr())) != 0:
        raise RuntimeError("dsm_min_probe failed")
    got = out.tolist()
    least = list(range(5, 13))
    return {name: {"first_readers": got[i],
                   "least_values": got[3 + 8 * i:11 + 8 * i] == least}
            for i, name in enumerate(("atomicMin 64", "cas_min 64",
                                      "atomicMin 32"))}


def variants(parent: str) -> dict:
    """kernel -> variant -> (source file or text, include directory)."""
    here = _build.ROUTING_CSRC

    def edited(name: str, old: str, new: str) -> str:
        with open(os.path.join(here, name)) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once")
        return text.replace(old, new)

    return {
        "route_sweep": {
            "parent": (os.path.join(parent, "route_sweep.cu"), parent),
            "w512": (edited("route_sweep.cu", "#define R1_THREADS 1024",
                            "#define R1_THREADS 512"), here),
            "w1024": (os.path.join(here, "route_sweep.cu"), here)},
        "mcf_ssp": {
            "parent": (os.path.join(parent, "mcf_ssp.cu"), parent),
            "new": (os.path.join(here, "mcf_ssp.cu"), here),
            "global": (edited("mcf_ssp.cu", "int dsm, void *stream) {",
                              "int dsm, void *stream) {\n    dsm = 0;"),
                       here)}}


def parent_r1(args):
    """The earlier R1's wrapper: its outputs and scratch, one launch."""
    planes, ok, lanes, n, hops = args[:7], args[7], args[8:13], args[13], \
        args[14]
    B, E = ok.shape
    dv = ok.device

    def run():
        out = (torch.empty(B, dtype=torch.int64, device=dv),
               torch.empty((B, n), dtype=torch.int32, device=dv),
               torch.empty(B, dtype=torch.uint8, device=dv))
        scratch = (torch.empty((B, 6, n), dtype=torch.int64, device=dv),
                   torch.empty((B, n), dtype=torch.int32, device=dv))
        ops = [*planes, ok.view(torch.uint8), *lanes, *out, *scratch]
        HR._launch("route_sweep", ops, [B, E, n, hops],
                   [t.dtype for t in ops])
        return out[0], out[1], out[2].bool()
    return run


def parent_r2(arcs, lanes, n_pad):
    """The earlier R2's wrapper: residuals cloned, flows zeroed, its
    scratch, one launch."""
    fwd_cost, fwd_res, src, dst, amount, cap = lanes
    B, Af = fwd_cost.shape
    dv = fwd_cost.device

    def run():
        res = fwd_res.clone()
        flow = torch.zeros((B, Af), dtype=torch.int64, device=dv)
        out = (torch.empty(B, dtype=torch.int64, device=dv),
               torch.empty(B, dtype=torch.uint8, device=dv),
               torch.empty(B, dtype=torch.uint8, device=dv),
               torch.empty((B, 3), dtype=torch.int64, device=dv))
        scratch = (torch.empty((B, n_pad), dtype=torch.float64, device=dv),
                   torch.empty((B, n_pad), dtype=torch.int32, device=dv),
                   torch.empty((B, n_pad), dtype=torch.int64, device=dv),
                   torch.empty((B, n_pad), dtype=torch.int32, device=dv),
                   torch.empty((B, 2, n_pad), dtype=torch.int32,
                               device=dv))
        ops = [*arcs[:4], fwd_cost, res, flow, src, dst, amount, cap, *out,
               *scratch]
        HR._launch("mcf_ssp", ops, [B, Af, n_pad], [t.dtype for t in ops])
        return flow, out[0], out[1].bool(), out[2].bool()
    return run


def use(name: str, lib: ctypes.CDLL):
    """Make the wrappers launch `name` from `lib`."""
    _build._libs[name] = lib
    HR._kernel.cache_clear()


def pair(g, rng) -> tuple[int, int]:
    """bench.py's random node pair (a == b moves b on by one)."""
    a, b = (int(x) for x in rng.integers(0, g.n_nodes, 2))
    return a, (b + 1) % g.n_nodes if a == b else b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--channels", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=12_500)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("routing_ablation: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="routing_ablation_")
    built = build(variants(os.path.abspath(args.parent)),
                  os.path.join(tmp, "build"))
    record = {"card": card, "reports": {}, "ms": {},
              "dsm_min_probe": dsm_min_probe(tmp)}
    print(f"minima folded into another block's shared memory: "
          f"{json.dumps(record['dsm_min_probe'])}", flush=True)
    for k, vs in built.items():
        for v, (_, report) in vs.items():
            record["reports"][f"{k}/{v}"] = report
            print(f"{k}/{v}: {report}", flush=True)

    path = os.path.join(tmp, "graph.gs")
    synth.make_network_store(path, args.channels, args.nodes,
                             seed=args.seed, device=dev)
    g = gossmap.from_store(store.load_store(path))
    planes = RoutePlanes.build(g, dev)
    plane_args, _ = RD._device_plane_args(planes)
    in_off = planes.dev["in_off"]
    rng = np.random.default_rng(11)
    pr = [pair(g, rng) for _ in range(RD.ROUTE_BATCH)]
    B = len(pr)
    lanes = [np.stack([planes.edge_ok_mask()] * B),
             np.array([a for a, _ in pr], np.int32),
             np.array([b for _, b in pr], np.int32),
             np.full(B, 1_000_000, np.int64), np.full(B, 18, np.int64),
             np.full(B, 10, np.int64)]
    r1_args = (*plane_args, *(torch.as_tensor(a, device=dev)
                              for a in lanes),
               planes.n_pad, RD.DEFAULT_MAX_HOPS)
    mp = MD.McfPlanes.build(g, dev)
    arcs = mp.device_arcs()
    rng = np.random.default_rng(13)
    qs = []
    for _ in range(MD.MCF_BATCH):
        a, b = pair(g, rng)
        qs.append(MD.McfQuery(bytes(g.node_ids[a]), bytes(g.node_ids[b]),
                              int(rng.integers(100_000, 50_000_000)),
                              max_parts=8))
    r2_lanes = [torch.as_tensor(x, device=dev) for x in MD._prep_chunk(
        mp, qs, MD.MCF_BATCH, 1.0, [None] * MD.MCF_BATCH)]

    # name -> (the library the wrappers launch, the call)
    r1, r2 = built["route_sweep"], built["mcf_ssp"]
    runs = {"route_sweep parent": (r1["parent"][0], parent_r1(r1_args))}
    for w in ("w512", "w1024"):
        for C in HR.CLUSTER_SIZES:
            runs[f"route_sweep {w} C={C}"] = (
                r1[w][0], lambda C=C: HR.route_sweep(
                    *r1_args, in_off=in_off, _cluster=C))
    runs["mcf_ssp parent"] = (r2["parent"][0],
                              parent_r2(arcs, r2_lanes, mp.n_pad))
    for v in ("new", "global"):
        for C in HR.CLUSTER_SIZES:
            if v == "global" and not HR.r2_shared(HR.split(mp.n_pad, C)[0]):
                continue
            runs[f"mcf_ssp {v} C={C}"] = (
                r2[v][0], lambda C=C: HR.mcf_solve(*arcs, *r2_lanes,
                                                   mp.n_pad, _cluster=C))
    want = {"route_sweep": HR.route_sweep_plain(*r1_args),
            "mcf_ssp": HR.mcf_solve_plain(*arcs[:2], *r2_lanes, mp.n_pad)}
    for name, (lib, run) in runs.items():
        use(name.split()[0], lib)
        got = run()
        bad = sum(int((a != b).sum())
                  for a, b in zip(got, want[name.split()[0]]))
        print(f"{name}: {bad} mismatching elements against the plain "
              f"version", flush=True)
        if bad:
            raise RuntimeError(f"{name} disagrees with its plain version")
    order = list(runs) + list(runs)[::-1]
    for name in order:
        lib, run = runs[name]
        use(name.split()[0], lib)
        ms = time_ms(run)
        record["ms"].setdefault(name, []).append(ms)
        print(f"{name}: {ms:.4f} ms/call on {card}", flush=True)
    for name, (a, b) in record["ms"].items():
        print(f"{name}: {a:.4f} / {b:.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
