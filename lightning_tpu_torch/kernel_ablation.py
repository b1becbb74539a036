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

* K6 ``dual_mul_planes``: ``parent`` (DIR's source and header);
  ``bounds`` (the parent's source and window loop, which reads a
  window's points after its doublings and inlines pt_add twice, at 256
  threads a block under ``__launch_bounds__(256, 2)``); ``one_add``
  (``bounds`` with the two additions through one loop, one copy of
  pt_add in the code); ``prefetch`` (this tree's source: the 64-window
  scan body K5 and K6 share, one copy of pt_add, a window's two points
  copied by cp.async into a shared-memory slot before its doublings);
* K5 ``dual_mul_v2``: ``parent``, ``bounds``, ``one_add`` and
  ``prefetch`` as K6's, all four over the table as (16, 3, 8, B)
  planes, the batch fastest (``prefetch`` fetches the digit's entry word
  by word, 24 4-byte copies); ``rows`` (this tree's source: the table
  signature-major, (B, 16, 3, 8), an entry by six 16-byte copies);
* K1 ``verify_prep``, K2 ``build_tables``, K3 ``glv_scan``, K4
  ``glv_scan2``: ``parent`` and ``new`` (this tree's source).

Every variant's outputs must equal this tree's kernel's on the same
random inputs at B = bucket (the script fails otherwise).  Then each is
timed with CUDA events (20 calls after 2 warm-up calls) in the order of
its steps and back again (a b c c b a), so a drift of the card's clock
shows as a difference between a variant's two readings; K3's, K4's and
K5's variants also with every digit and joint index one fixed value, so
the difference is what their gathers cost.  Last, K5's parent is built
a second time (``parent2``, the same source and flags) and both builds
are timed on the inputs above (A) and on a copy of them in new
allocations (B), in the order parent/A, parent2/B, parent2/A, parent/B
and back: a gap that follows the buffers and not the build is where the
data lie, not the code.  Prints one line per reading and the ptxas
report of every variant (with its blocks per SM where the library
reports them, and its SASS instructions as ``cuobjdump -sass`` lists
them), names the variant each kernel ships, and writes all of it, with
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

import numpy as np
import torch

from . import _build
from .crypto import hopper_secp as H

REPS, WARM = 20, 2

# K5's table as (16, 3, 8, B) planes, the batch fastest: the digit's
# entry fetched word by word into the slot, as K6 fetches its Q row.
K5_PLANES_TABLE = r"""
struct dual_q_tplanes {
    const int32_t *d2;
    const uint32_t *qtab;
};
HD int q_sel(const dual_q_tplanes &f, int w, long long stride) {
    return f.d2[w * stride] & 15;
}
HD void q_fetch(uint32_t *slots, int t, int step, const dual_q_tplanes &f,
                int j, long long stride) {
    plane_fetch(slots + t, step, f.qtab, stride, j);
}
HD void q_point(pt &q, const uint32_t *slots, int t, int step,
                const dual_q_tplanes &) {
    slot_point(q, slots + t, step, 0);
}
"""

# The parent's 64-window loop with the window's two additions through
# one loop over the two points, so pt_add is inlined once.  d2 = null
# takes K6's Q planes row by row, else K5's table entry by digit.
ONE_ADD = r"""
__device__ __forceinline__ void one_add_scan(const int32_t *d2,
                                             const uint32_t *qs,
                                             const uint32_t *gs,
                                             long long stride, pt &acc) {
    pt q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < DUAL_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
#pragma unroll 1
        for (int e = 0; e < 2; e++) {
            int j = e || !d2 ? w : d2[w * stride] & 15;
            plane_load(q, e ? gs : qs, stride, j);
            pt_add(acc, acc, q);
        }
    }
}
"""
INCLUDE = '#include "secp256k1.cuh"\n'

# K3, K4 and K5 are also timed with fixed digits (their first n inputs).
FIXED_INPUTS = {"glv_scan": 3, "glv_scan2": 2, "dual_mul_v2": 1}
# K5's variants that take the table signature-major, (B, 16, 3, 8).
ROWS = {"dual_mul_v2": {"rows"}}
# Two builds of one source, timed on two sets of buffers (the placement
# check) and not among the steps.
PLACEMENT = {"dual_mul_v2": ("parent", "parent2")}


def edit(src: str, *pairs: tuple[str, str]) -> str:
    """`src` with each (old, new) pair replaced; each old must occur
    once."""
    for old, new in pairs:
        assert src.count(old) == 1, f"not once in the source: {old!r}"
        src = src.replace(old, new)
    return src


def variants(parent: str) -> dict[str, dict[str, tuple]]:
    """kernel -> variant -> (source path or text, include dir), in the
    order of the steps."""
    here = _build.CRYPTO_CSRC

    def read(d, k):
        with open(os.path.join(d, _build.SOURCES[k])) as f:
            return f.read()

    def bounds(k):
        """The parent's source of k at 256 threads a block under
        ``__launch_bounds__(256, 2)`` (text, since nvcc's -D would
        split the value at its comma)."""
        return edit(read(parent, k),
                    (f"__global__ void {k}_kernel(",
                     f"__global__ void __launch_bounds__(256, 2) "
                     f"{k}_kernel("),
                    ("const int threads = 128;", "const int threads = 256;"))

    def old(k):
        return os.path.join(parent, _build.SOURCES[k]), parent

    def own(k):
        return os.path.join(here, _build.SOURCES[k]), here

    one_add = {
        "dual_mul_planes": edit(
            bounds("dual_mul_planes"), (INCLUDE, INCLUDE + ONE_ADD),
            ("dual_mul_planes_one(qs + i, gs + i, B, acc);",
             "one_add_scan(nullptr, qs + i, gs + i, B, acc);")),
        "dual_mul_v2": edit(
            bounds("dual_mul_v2"), (INCLUDE, INCLUDE + ONE_ADD),
            ("dual_mul_v2_one(d2 + i, B, qtab + i, gs + i, acc);",
             "one_add_scan(d2 + i, qtab + i, gs + i, B, acc);")),
    }
    k5_planes = edit(
        read(here, "dual_mul_v2"), (INCLUDE, INCLUDE + K5_PLANES_TABLE),
        ("const dual_q_table q = {d2 + i, qtab + (long long)i * "
         "DUAL_QTAB_WORDS};", "const dual_q_tplanes q = {d2 + i, qtab + i};"))
    out = {
        "dual_mul_planes": {"parent": old("dual_mul_planes"),
                            "bounds": (bounds("dual_mul_planes"), parent),
                            "one_add": (one_add["dual_mul_planes"], parent),
                            "prefetch": own("dual_mul_planes")},
        "dual_mul_v2": {"parent": old("dual_mul_v2"),
                        "bounds": (bounds("dual_mul_v2"), parent),
                        "one_add": (one_add["dual_mul_v2"], parent),
                        "prefetch": (k5_planes, here),
                        "rows": own("dual_mul_v2"),
                        "parent2": (read(parent, "dual_mul_v2"), parent)},
    }
    for k in ("verify_prep", "build_tables", "glv_scan", "glv_scan2"):
        out[k] = {"parent": old(k), "new": own(k)}
    return out


def shipped(table) -> dict[str, str]:
    """kernel -> the variant whose source is this tree's."""
    out = {}
    for k, vs in table.items():
        with open(os.path.join(_build.CRYPTO_CSRC, _build.SOURCES[k])) as f:
            mine = f.read()
        for v, (src, inc) in vs.items():
            text = src
            if os.path.exists(src):
                with open(src) as f:
                    text = f.read()
            if inc == _build.CRYPTO_CSRC and text == mine:
                out[k] = v
    return out


def build(table, outdir: str) -> dict[str, dict[str, tuple]]:
    """Compile every variant at once (a variant's source is a file or
    its text); returns kernel -> variant -> (loaded library, report: ptxas
    and the SASS instructions and CALLs, ``cuobjdump -sass``)."""
    os.makedirs(outdir, exist_ok=True)
    jobs = {}
    for k, vs in table.items():
        for v, (src, inc) in vs.items():
            if not os.path.exists(src):
                path = os.path.join(outdir, f"{k}_{v}.cu")
                with open(path, "w") as f:
                    f.write(src)
                src = path
            jobs[k, v] = (src, inc, os.path.join(outdir, f"lib{k}_{v}.so"))
    reports = _build.nvcc_all(jobs)
    built: dict[str, dict[str, tuple]] = {}
    for (k, v), (_, _, lib) in jobs.items():
        fns = _build.sass(lib)
        report = reports[k, v].replace("\n", " | ")
        if fns is not None:
            calls = sum(c for c, _ in _build.sass_calls(fns).values())
            report += (f" | {sum(map(len, fns.values()))} SASS "
                       f"instructions, {calls} CALL")
        built.setdefault(k, {})[v] = (ctypes.CDLL(lib), report)
    return built


def launcher(lib: ctypes.CDLL, kernel: str, args: list, B: int):
    fn = _build.c_launch(lib, kernel, len(args), 1)
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


def operands(k: str, v: str, ins: list) -> list:
    """The inputs of variant v of kernel k: K5's ``rows`` takes the
    table, (16, 3, 8, B) in `ins`, as (B, 16, 3, 8)."""
    if v in ROWS.get(k, ()):
        return [ins[0], ins[1].permute(3, 0, 1, 2).contiguous(), *ins[2:]]
    return ins


def placement(k: str, vs: dict, ins: list, outs: list, B: int) -> dict:
    """Two builds of one source of k, each timed on `ins` and `outs` (A)
    and on copies of them in new allocations (B), in turns and back."""
    a, b = PLACEMENT[k]
    bufs = {"A": ins + outs,
            "B": [t.clone() for t in ins] + [torch.empty_like(o)
                                             for o in outs]}
    order = [(a, "A"), (b, "B"), (b, "A"), (a, "B")]
    got: dict[str, list] = {f"{v}/{side}": [] for v, side in order}
    for v, side in order + order[::-1]:
        ms = time_ms(launcher(vs[v][0], k, bufs[side], B))
        got[f"{v}/{side}"].append(ms)
        print(f"time {k}/{v} on buffers {side}: {ms:.4f} ms/call",
              flush=True)
    return got


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
              "ptxas": {}, "ms": {}, "fixed_digits_ms": {},
              "placement_ms": {}}
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
        mine = operands(k, record["shipped"][k], ins)
        launcher(_build.lib(k), k, mine + want, B)()
        runs = {v: launcher(lib, k, operands(k, v, ins) + outs, B)
                for v, (lib, _) in vs.items()}
        for v, run in runs.items():
            for o in outs:
                o.fill_(-1)
            run()
            torch.cuda.synchronize()
            assert all(torch.equal(o, w) for o, w in zip(outs, want)), \
                f"{k}/{v} disagrees with this tree's kernel"
        steps = [v for v in runs if v not in PLACEMENT.get(k, ())[1:]]
        record["ms"][k] = {v: [] for v in steps}
        for v in steps + steps[::-1]:
            ms = time_ms(runs[v])
            record["ms"][k][v].append(ms)
            print(f"time {k}/{v}: {ms:.4f} ms/call at B={B}", flush=True)
        if k in FIXED_INPUTS:
            n = FIXED_INPUTS[k]
            fixed = [torch.full_like(t, 5) for t in ins[:n]]
            frun = {v: launcher(vs[v][0], k,
                                operands(k, v, fixed + ins[n:]) + outs, B)
                    for v in steps}
            record["fixed_digits_ms"][k] = {v: [] for v in steps}
            for v in steps + steps[::-1]:
                ms = time_ms(frun[v])
                record["fixed_digits_ms"][k][v].append(ms)
                print(f"time {k}/{v} fixed digits: {ms:.4f} ms/call",
                      flush=True)
        if k in PLACEMENT:
            record["placement_ms"][k] = placement(k, vs, ins, outs, B)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"ablation": record["ms"],
                      "fixed_digits_ms": record["fixed_digits_ms"],
                      "placement_ms": record["placement_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
