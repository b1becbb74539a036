"""The kernel redesigns on the card, each step timed against the one
before it in one process.

    python -m lightning_tpu_torch.kernel_ablation --parent DIR
        [--kernels verify_prep,fixed_base,ecdsa_sign] [--bucket 65536]
        [--small 483] [--out FILE]

DIR holds an earlier commit's ``crypto/csrc`` (the header and the eight
sources), unpacked outside git, for example

    git archive <commit> lightning_tpu_torch/crypto/csrc \\
        | tar -x -C lightning_tpu_torch/_build/parent

Variants of each kernel in --kernels, each built with
``_build.NVCC_FLAGS`` (one nvcc process each, all at once), in the order
of their steps:

* S2 ``ecdsa_sign``: ``parent`` (DIR's source and header: a thread a
  row, its candidates in a loop, a Fermat chain a candidate and a row);
  then this tree's source with its later steps undone by edits, in
  order: ``rounds`` (candidate rounds compacted across a block of 256,
  idle threads taking pending rows' next candidates, a chain a job and a
  row, a block a tile, no register cap), ``+inv_p`` (one batch inversion
  mod p a round), ``+inv_n`` (one mod n a tile), ``waves`` (at most 128
  registers, the grid from the occupancy query, blocks looping over
  tiles, the rows spread over every block), ``threads512`` (this tree's
  source: 512 threads, one block an SM); and beside it ``threads128``
  and ``free256`` (256 threads, no register cap);
* S1 ``fixed_base``: ``parent``; ``+inv_p`` (one batch inversion mod p
  a block of 256, a block a tile, no register cap); ``waves`` (512
  threads, 128 registers, the grid from the occupancy query, the keys
  spread over every block); ``smem`` (this tree's source: the comb
  table in shared memory, one bulk asynchronous copy a block);
  ``free256`` (256 threads, no register cap);
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

K5's and K6's steps edit the sources of the commit before their redesign
(the one whose window loops still inline pt_add twice): pass that
commit's csrc as DIR with them.

Every variant's outputs must equal this tree's kernel's on the same
random inputs (the script fails otherwise): K1-K6 at B = bucket, S1 and
S2 (C = 4 and C = 1, random nonces) at B = bucket and at B = small (a
483-HTLC commitment).  Then each is timed with CUDA events (20 calls
after 2 warm-up calls) in the order of its steps and back again (a b c c
b a), so a drift of the card's clock shows as a difference between a
variant's two readings; K3's, K4's and K5's variants also with every
digit and joint index one fixed value, so the difference is what their
gathers cost.  With K5, its parent is built a second time (``parent2``,
the same source and flags) and both builds are timed on the inputs above
(A) and on a copy of them in new allocations (B), in the order
parent/A, parent2/B, parent2/A, parent/B and back: a gap that follows
the buffers and not the build is where the data lie, not the code.
Prints one line per reading and the ptxas report of every variant (with
its blocks per SM where the library reports them, and its SASS
instructions as ``cuobjdump -sass`` lists them), names the variant each
kernel ships, and writes all of it, with the card's name and power
limit, to FILE as JSON if --out is given.  Needs a CUDA device and nvcc.
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

# The steps of S1's and S2's designs, undone as edits of their sources
# as the redesign left them (each old text occurs once; where a later
# source lacks one, the variant is left out with a note): a Fermat
# chain a job, a row or a key instead of a block's batch inversion
# (INV_P, INV_N); a block a tile of THREADS rows with no register cap
# instead of the occupancy-sized grid (_waves); the table read from
# global memory through the read-only cache instead of its copy in shared
# memory (S1_LDG); the block size and its blocks an SM (_threads).
S2_INV_P = ("""            // jobs lie on the threads below p C (their level is below C)
            const int nw = warps_for(p * C < S2_THREADS ? p * C : S2_THREADS,
                                     S2_WARPS);
            block_inv<mod_p, S2_WARPS>(zi, acc.z, nw, sm.inv);
""", "            if (job) fp_inv(zi, acc.z);\n")
S2_INV_N = ("""        block_inv<mod_n, S2_WARPS>(w, k, warps_for(n, S2_WARPS), sm.inv);
        fn_mont_mul(kinv, w, r2);                 // k^-1 R
""", """        fn_mont_mul(w, k, r2);
        fn_inv_mont(kinv, w);
""")


def _threads(pre: str, n: int, min_blocks: int = 1) -> tuple:
    """Blocks of n threads under __launch_bounds__(n, min_blocks)."""
    out = ((f"#define {pre}_THREADS 512", f"#define {pre}_THREADS {n}"),)
    if min_blocks != 1:
        out += ((f"__launch_bounds__({pre}_THREADS, 1)",
                 f"__launch_bounds__({pre}_THREADS, {min_blocks})"),)
    return out


def _waves(pre: str) -> tuple:
    return ((f"__launch_bounds__({pre}_THREADS, 1)",
             f"__launch_bounds__({pre}_THREADS)"),
            ("    const tiling g = spread(", "    const tiling g0 = spread("),
            ("    if (g.grid == 0) return",
             f"    const tiling g = {{{pre}_THREADS, (B + {pre}_THREADS - 1) / "
             f"{pre}_THREADS}};\n    if (g0.grid == 0) return"))


S1_LDG = (("#define S1_SMEM_BYTES COMB_TABLE_BYTES", "#define S1_SMEM_BYTES 0"),
          ("""    extern __shared__ __align__(16) uint32_t table[];
    __shared__ uint64_t table_bar;
    comb_table_to_shared(table, comb, &table_bar);
""", "    const uint32_t *table = comb;\n"),
          ("comb_mul_one<false>(", "comb_mul_one<true>("))
# variant -> edits, in the order of the steps
S2_STEPS = {
    "rounds": (*_threads("S2", 256), S2_INV_P, S2_INV_N, *_waves("S2")),
    "+inv_p": (*_threads("S2", 256), S2_INV_N, *_waves("S2")),
    "+inv_n": (*_threads("S2", 256), *_waves("S2")),
    "waves": _threads("S2", 256, 2),
}
S2_SIZES = {"threads128": _threads("S2", 128, 4),
            "free256": _threads("S2", 256)}
S1_STEPS = {"+inv_p": (*_threads("S1", 256), *_waves("S1"), *S1_LDG),
            "waves": S1_LDG}
S1_SIZES = {"free256": _threads("S1", 256)}

# The sign kernels' launches: entry point -> candidates (0 for S1)
SIGN_ENTRIES = {"fixed_base": {"fixed_base": 0},
                "ecdsa_sign": {"ecdsa_sign4": 4, "ecdsa_sign1": 1}}

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


def variants(parent: str, kernels: list[str]) -> dict[str, dict[str, tuple]]:
    """kernel -> variant -> (source path or text, include dir), in the
    order of the steps, for each kernel in `kernels`."""
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

    def steps(k, table):
        """Variant -> this tree's source of k with the edits undoing later
        steps, for each variant whose edits fit the source."""
        out = {}
        for v, edits in table.items():
            try:
                out[v] = edit(read(here, k), *edits), here
            except AssertionError as e:
                print(f"left out {k}/{v}: {e}", flush=True)
        return out

    out: dict[str, dict[str, tuple]] = {}
    for k in ("verify_prep", "build_tables", "glv_scan", "glv_scan2"):
        out[k] = {"parent": old(k), "new": own(k)}
    out["ecdsa_sign"] = {"parent": old("ecdsa_sign"),
                         **steps("ecdsa_sign", S2_STEPS),
                         "threads512": own("ecdsa_sign"),
                         **steps("ecdsa_sign", S2_SIZES)}
    out["fixed_base"] = {"parent": old("fixed_base"),
                         **steps("fixed_base", S1_STEPS),
                         "smem": own("fixed_base"),
                         **steps("fixed_base", S1_SIZES)}
    if not {"dual_mul_planes", "dual_mul_v2"} & set(kernels):
        return {k: out[k] for k in kernels}
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
    out["dual_mul_planes"] = {
        "parent": old("dual_mul_planes"),
        "bounds": (bounds("dual_mul_planes"), parent),
        "one_add": (one_add["dual_mul_planes"], parent),
        "prefetch": own("dual_mul_planes")}
    out["dual_mul_v2"] = {
        "parent": old("dual_mul_v2"),
        "bounds": (bounds("dual_mul_v2"), parent),
        "one_add": (one_add["dual_mul_v2"], parent),
        "prefetch": (k5_planes, here),
        "rows": own("dual_mul_v2"),
        "parent2": (read(parent, "dual_mul_v2"), parent)}
    return {k: out[k] for k in kernels}


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


def sign_inputs(entry: str, B: int, dev) -> tuple[list, list]:
    """(input tensors, output tensors) of a sign kernel's entry point at
    size B: random scalars, hashes, keys and nonces (< 2^255, below n) from
    seed 12, and the comb table."""
    gen = np.random.default_rng(12)

    def words(*shape):
        w = gen.integers(0, 2**32, (*shape, 8, B), dtype=np.uint32)
        w[..., 7, :] &= 0x7FFFFFFF
        return torch.as_tensor(w.view(np.int32), device=dev).contiguous()

    def out(dtype=torch.int32, *shape):
        return torch.empty((*shape, B), dtype=dtype, device=dev)

    comb = H._comb_words(str(dev))
    C = SIGN_ENTRIES["ecdsa_sign"].get(entry, 0)
    if not C:
        return [words(), comb], [out(torch.int32, 8), out(torch.int32, 8)]
    return ([words(), words(), words(C), comb],
            [out(torch.int32, 8), out(torch.int32, 8), out(torch.uint8),
             out(torch.uint8)])


def cases(kernels: list[str], bucket: int, small: int) -> list[tuple]:
    """(kernel, entry point, B) of every timed case: K1-K6 at the bucket,
    S1 and S2 (each entry point) at the bucket and at `small`."""
    out = []
    for k in kernels:
        for entry in SIGN_ENTRIES.get(k, {k: 0}):
            for B in ((bucket, small) if k in SIGN_ENTRIES else (bucket,)):
                out.append((k, entry, B))
    return out


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
    ap.add_argument("--kernels", default="verify_prep,fixed_base,ecdsa_sign",
                    help="comma-separated kernel libraries to ablate")
    ap.add_argument("--bucket", type=int, default=65536)
    ap.add_argument("--small", type=int, default=483,
                    help="the sign kernels' second size (a commitment)")
    ap.add_argument("--out", help="write the whole record here as JSON")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(_build.SOURCES)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
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
    table = variants(os.path.abspath(args.parent), kernels)
    built = build(table, os.path.join(_build.BUILD_DIR, "ablation"))
    record = {"card": card, "B": B, "small": args.small, "reps": REPS,
              "shipped": shipped(table), "ptxas": {}, "ms": {},
              "fixed_digits_ms": {}, "placement_ms": {}}
    print(f"shipped: {json.dumps(record['shipped'])}", flush=True)
    for k, vs in built.items():
        for v, (lib, rep) in vs.items():
            if hasattr(lib, f"{k}_blocks_per_sm"):
                n = getattr(lib, f"{k}_blocks_per_sm")()
                rep += f" | {n} blocks per SM"
            record["ptxas"][f"{k}/{v}"] = rep
            print(f"ptxas {k}/{v}: {rep}", flush=True)
    data = inputs(B, dev) if set(kernels) - set(SIGN_ENTRIES) else {}
    for k, entry, n in cases(kernels, B, args.small):
        vs = built[k]
        ins, outs = data[k] if k in data else sign_inputs(entry, n, dev)
        label = k if k not in SIGN_ENTRIES else f"{entry}@{n}"
        want = [torch.empty_like(o) for o in outs]
        mine = operands(k, record["shipped"][k], ins)
        launcher(_build.lib(k), entry, mine + want, n)()
        runs = {v: launcher(lib, entry, operands(k, v, ins) + outs, n)
                for v, (lib, _) in vs.items()}
        for v, run in runs.items():
            for o in outs:
                o.fill_(-1 if o.dtype == torch.int32 else 255)
            run()
            torch.cuda.synchronize()
            assert all(torch.equal(o, w) for o, w in zip(outs, want)), \
                f"{label}/{v} disagrees with this tree's kernel"
        steps = [v for v in runs if v not in PLACEMENT.get(k, ())[1:]]
        record["ms"][label] = {v: [] for v in steps}
        for v in steps + steps[::-1]:
            ms = time_ms(runs[v])
            record["ms"][label][v].append(ms)
            print(f"time {label}/{v}: {ms:.4f} ms/call at B={n}", flush=True)
        if k in FIXED_INPUTS:
            m = FIXED_INPUTS[k]
            fixed = [torch.full_like(t, 5) for t in ins[:m]]
            frun = {v: launcher(vs[v][0], k,
                                operands(k, v, fixed + ins[m:]) + outs, n)
                    for v in steps}
            record["fixed_digits_ms"][k] = {v: [] for v in steps}
            for v in steps + steps[::-1]:
                ms = time_ms(frun[v])
                record["fixed_digits_ms"][k][v].append(ms)
                print(f"time {k}/{v} fixed digits: {ms:.4f} ms/call",
                      flush=True)
        if k in PLACEMENT:
            record["placement_ms"][k] = placement(k, vs, ins, outs, n)
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
