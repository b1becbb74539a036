"""The routing path's two hand-written CUDA kernels: wrappers, plain
versions and launch counters.

* R1 ``csrc/route_sweep.cu``: wrapper ``route_sweep``, plain version
  ``route_sweep_plain``; replaces lightning_tpu/routing/device.py
  ``_make_single`` :144 (``_jit_route`` :203);
* R2 ``csrc/mcf_ssp.cu``: wrapper ``mcf_solve``, plain version
  ``mcf_solve_plain``; replaces lightning_tpu/routing/mcf_device.py
  ``_make_mcf_single`` :419 (``_jit_mcf`` :514).

Each kernel runs a query on a thread block cluster of ``R1_CLUSTER`` /
``R2_CLUSTER`` blocks, the fastest sizes at phase 7's shapes on the H100
(PERF.md section 6), the query's node labels split by node range across
the blocks.  R1 keeps them in global memory.  R2 keeps them in the
blocks' shared memory where they fit (32 bytes a node: up to 65,536
nodes at 16 blocks), else in global memory.  No size or placement is
retried: a refused launch raises.  The keyword ``_cluster`` launches
another size; only the per-size sweep of ``chip_smoke.py``, the card
tests and ``routing_ablation.py`` use it.

Each plain version is the JAX program written out in PyTorch, the vmap
a batch dimension and the scans loops; ``segment_min`` becomes
``scatter_reduce(amin)`` over a buffer that starts at the dtype's
maximum (+inf for floats), as an empty segment's minimum is there.  A
wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper raises its
plain integer ``<wrapper>.launches`` by one where it launches the kernel
and nowhere else.

The plain MCF solve stops its rounds once a round changes no query's
labels, and its augmentations once no query is active: the JAX
program's remaining rounds and steps leave the state as it is (a
round's labels are a function of the labels before it; an inactive
query stays inactive and nothing of it changes), so the outputs are the
same (tests/test_torch_mcf.py holds them against ``_jit_mcf``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

INF_COST = 1 << 62          # route label sentinel
OVF_LIMIT = 1 << 61         # per-edge product bound
RISK_DENOM = 52596 * 100    # dijkstra.BLOCKS_PER_YEAR * 100
I64_MAX = (1 << 63) - 1
I32_MAX = (1 << 31) - 1

MAX_ROUNDS = 40             # routing/mcf.py MAX_ROUNDS
AUG_STEPS = 64              # 4 * mcf.MAX_PARTS
WALK_CAP = 64               # predecessor-walk budget per augmentation
EPS = 1e-9                  # mcf._shortest_path's tolerance

CLUSTER_SIZES = (1, 2, 4, 8, 16)
R1_CLUSTER = 2
R2_CLUSTER = 16
# dynamic shared memory a block may take, less the kernels' static share
SMEM_LIMIT = 232_448 - 1_024
R2_NODE_BYTES = 8 + 8 + 4 * 4   # dist, key; arc, pred, 2 lists


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


@functools.lru_cache(maxsize=None)
def _kernel(name: str, n_ptr: int, n_int: int):
    return _build.c_launch(_build.lib(name), name, n_ptr, n_int)


def _launch(name: str, tensors: list, ints: list, dtypes: list) -> None:
    """Launch ``<name>_launch`` on the current stream after checking
    that each operand is a contiguous CUDA tensor of its dtype."""
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if not (t.is_cuda and t.is_contiguous() and t.dtype == dt):
            raise ValueError(f"{name}: operand {i} must be a contiguous "
                             f"{dt} CUDA tensor, got {t.dtype} on "
                             f"{t.device}")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = _kernel(name, len(tensors), len(ints))(
        *(ctypes.c_void_p(t.data_ptr()) for t in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def split(n_nodes: int, cluster: int) -> tuple[int, int]:
    """A cluster's split of n_nodes: (nodes a block, a power of two; its
    log2).  Node v belongs to block v // per."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}")
    per = 1
    while per * cluster < n_nodes:
        per <<= 1
    return per, per.bit_length() - 1


def r2_shared(per: int) -> bool:
    """Whether R2 keeps a block's node entries, per nodes, in its
    shared memory."""
    return per * R2_NODE_BYTES <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# R1: the route sweep


def route_sweep_plain(edge_src, edge_dst, base, ppm, cd, hmin, hmax,
                      edge_ok, src, dst, amount, final_cltv, riskfactor,
                      n_nodes: int, max_hops: int, in_off=None):
    """Plain version of R1, ``_make_single`` over a batch: max_hops full
    sweeps.  Planes (E,): edge_src, edge_dst int32, base, ppm, cd, hmin,
    hmax int64; per query edge_ok (B, E) bool, src, dst (B,) int32,
    amount, final_cltv, riskfactor (B,) int64.  Returns (dist at src (B,)
    int64, via (B, n_nodes) int32, ovf (B,) bool).  ``in_off``, the
    kernel's in-edge offsets, is accepted and not read."""
    B, E = edge_ok.shape
    dv = edge_ok.device
    rows = torch.arange(B, device=dv)
    si = edge_src.long().expand(B, E)
    di = edge_dst.long().expand(B, E)
    dist = torch.full((B, n_nodes), INF_COST, dtype=torch.int64, device=dv)
    dist[rows, dst.long()] = 0
    amt = torch.zeros((B, n_nodes), dtype=torch.int64, device=dv)
    amt[rows, dst.long()] = amount
    dly = torch.zeros((B, n_nodes), dtype=torch.int64, device=dv)
    dly[rows, dst.long()] = final_cltv
    via = torch.full((B, n_nodes), -1, dtype=torch.int64, device=dv)
    eidx = torch.arange(E, device=dv).expand(B, E)
    # per-edge safe-amount ceiling: both int64 products stay < 2^61
    cdr = cd[None, :] * riskfactor[:, None]
    thr = torch.minimum(OVF_LIMIT // ppm.clamp(min=1)[None, :],
                        OVF_LIMIT // cdr.clamp(min=1))
    ovf = torch.zeros(B, dtype=torch.bool, device=dv)
    for _ in range(max_hops):
        d_v = dist.gather(1, di)
        a_v = amt.gather(1, di)
        ok = edge_ok & (d_v < INF_COST)
        # the HTLC carried over u->v is a_v (what v receives)
        ok &= (a_v >= hmin) & ((hmax == 0) | (a_v <= hmax))
        unsafe = a_v > thr
        ovf |= (ok & unsafe).any(1)
        ok &= ~unsafe
        fee = base + (a_v * ppm) // 1_000_000
        risk = 1 + (a_v * cdr) // RISK_DENOM
        cand = torch.where(ok, d_v + fee + risk, INF_COST)
        best = torch.full((B, n_nodes), I64_MAX, dtype=torch.int64,
                          device=dv).scatter_reduce(1, si, cand, "amin")
        improved = best < dist
        # tie-break: lowest edge index among the winning cost
        e_cand = torch.where(ok & (cand == best.gather(1, si)), eidx, E)
        best_e = torch.full((B, n_nodes), I32_MAX, dtype=torch.int64,
                            device=dv).scatter_reduce(1, si, e_cand, "amin")
        e_star = best_e.clamp(max=E - 1)
        v_star = edge_dst.long()[e_star]
        dist = torch.where(improved, best, dist)
        amt_next = torch.where(
            improved, amt.gather(1, v_star) + fee.gather(1, e_star), amt)
        dly = torch.where(improved, dly.gather(1, v_star) + cd[e_star], dly)
        amt = amt_next
        via = torch.where(improved, e_star, via)
    return dist[rows, src.long()], via.to(torch.int32), ovf


def route_sweep(edge_src, edge_dst, base, ppm, cd, hmin, hmax, edge_ok,
                src, dst, amount, final_cltv, riskfactor, n_nodes: int,
                max_hops: int, in_off=None, work: list | None = None,
                _cluster: int | None = None):
    """R1 wrapper; operands and results as ``route_sweep_plain``.  On the
    card the edges must be sorted by edge_dst and ``in_off`` (n_nodes +
    1,) int32 must hold the in-edges' offsets (``planes.in_csr``; an edge
    outside every range must be off in edge_ok): the kernel prices a
    sweep's frontier by them.  When `work` is a list, the kernel's (B,
    2) int64 tensor of sweeps run and edges priced a query is appended to
    it."""
    if not _on_card(edge_ok):
        return route_sweep_plain(edge_src, edge_dst, base, ppm, cd, hmin,
                                 hmax, edge_ok, src, dst, amount,
                                 final_cltv, riskfactor, n_nodes, max_hops)
    B, E = edge_ok.shape
    if in_off is None or in_off.shape != (n_nodes + 1,):
        raise ValueError("route_sweep: in_off must be (n_nodes + 1,)")
    C = _cluster or R1_CLUSTER
    per, shift = split(n_nodes, C)
    dv = edge_ok.device
    i32, i64, u8 = torch.int32, torch.int64, torch.uint8
    dist_src = torch.empty(B, dtype=i64, device=dv)
    via = torch.empty((B, n_nodes), dtype=i32, device=dv)
    ovf = torch.empty(B, dtype=u8, device=dv)
    w = torch.empty((B, 2), dtype=i64, device=dv)
    scratch = torch.empty((B, 6, C * per), dtype=i64, device=dv)
    scratch_e = torch.empty((B, 3, C * per), dtype=i32, device=dv)
    wl_e = torch.empty((B, E), dtype=i32, device=dv)
    wl_c = torch.empty((B, E), dtype=i64, device=dv)
    ops = [edge_src, edge_dst, in_off, base, ppm, cd, hmin, hmax,
           edge_ok.contiguous().view(u8), src, dst, amount, final_cltv,
           riskfactor, dist_src, via, ovf, w, scratch, scratch_e, wl_e,
           wl_c]
    kinds = [i32] * 3 + [i64] * 5 + [u8, i32, i32] + [i64] * 4 \
        + [i32, u8, i64, i64, i32, i32, i64]
    if any(t.shape != (E,) for t in ops[:2] + ops[3:8]) \
            or any(t.shape != (B,) for t in ops[9:14]):
        raise ValueError("route_sweep: planes must be (E,), query lanes "
                         "(B,)")
    _launch("route_sweep", ops, [B, E, n_nodes, max_hops, C, per, shift],
            kinds)
    route_sweep.launches += 1
    if work is not None:
        work.append(w)
    return dist_src, via, ovf.bool()


route_sweep.launches = 0


# ---------------------------------------------------------------------------
# R2: the min-cost-flow solve


def _interleave(fwd: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """(B, Af) forward and reverse lanes -> (B, 2 Af), arc 2k forward,
    2k + 1 its reverse."""
    return torch.stack([fwd, rev], dim=2).reshape(fwd.shape[0], -1)


def _bellman_ford(i_src, i_dst, cost, residual, src, n_pad: int):
    """MAX_ROUNDS Jacobi rounds over the live arcs; stops at the first
    round that changes no query's labels."""
    B, A = residual.shape
    dv = residual.device
    rows = torch.arange(B, device=dv)
    si = i_src.long().expand(B, A)
    di = i_dst.long().expand(B, A)
    aidx = torch.arange(A, device=dv).expand(B, A)
    acost = torch.where(residual > 0, cost, torch.inf)
    dist = torch.full((B, n_pad), torch.inf, dtype=torch.float64, device=dv)
    dist[rows, src.long()] = 0.0
    pred = torch.full((B, n_pad), -1, dtype=torch.int64, device=dv)
    for _ in range(MAX_ROUNDS):
        cand = dist.gather(1, si) + acost
        better = cand < dist.gather(1, di) - EPS
        candm = torch.where(better, cand, torch.inf)
        best = torch.full((B, n_pad), torch.inf, dtype=torch.float64,
                          device=dv).scatter_reduce(1, di, candm, "amin")
        improved = best < dist - EPS
        if not bool(improved.any()):
            break
        # tie-break: lowest arc index among the winning cost
        e_cand = torch.where(better & (cand == best.gather(1, di)), aidx, A)
        best_e = torch.full((B, n_pad), I32_MAX, dtype=torch.int64,
                            device=dv).scatter_reduce(1, di, e_cand, "amin")
        dist = torch.where(improved, best, dist)
        pred = torch.where(improved, best_e, pred)
    return dist, pred


def mcf_solve_plain(i_src, i_dst, fwd_cost, fwd_res, src, dst, amount,
                    aug_cap, n_pad: int):
    """Plain version of R2, ``_make_mcf_single`` over a batch.  Arcs
    i_src, i_dst (2 Af,) int32 (forward 2k, reverse 2k + 1); per query
    fwd_cost (B, Af) float64, fwd_res (B, Af) int64, src, dst (B,) int32,
    amount (B,) int64, aug_cap (B,) int32.  Returns (flow (B, Af) int64,
    remaining (B,) int64, nopath (B,) bool, walkfail (B,) bool)."""
    B = fwd_cost.shape[0]
    dv = fwd_cost.device
    rows = torch.arange(B, device=dv)
    cost = _interleave(fwd_cost, -fwd_cost)
    residual = _interleave(fwd_res, torch.zeros_like(fwd_res))
    src_l, dst_l = src.long(), dst.long()
    isrc_l = i_src.long()
    remaining = amount.clone()
    nopath = torch.zeros(B, dtype=torch.bool, device=dv)
    walkfail = torch.zeros(B, dtype=torch.bool, device=dv)
    for step in range(AUG_STEPS):
        active = (remaining > 0) & (step < aug_cap) & ~nopath & ~walkfail
        if not bool(active.any()):
            break
        dist, pred = _bellman_ford(i_src, i_dst, cost, residual, src, n_pad)
        reachable = torch.isfinite(dist[rows, dst_l])
        # follow predecessor arcs dst -> src; freeze at src
        v = dst_l
        path = []
        for _ in range(WALK_CAP):
            a = torch.where(v == src_l, -1, pred[rows, v])
            v = torch.where(a >= 0, isrc_l[a.clamp(min=0)], v)
            path.append(a)
        path = torch.stack(path, dim=1)
        walk_ok = v == src_l
        pvalid = path >= 0
        psafe = path.clamp(min=0)
        pres = torch.where(pvalid, residual.gather(1, psafe), 1 << 62)
        bottleneck = torch.minimum(remaining, pres.min(dim=1).values)
        apply = active & reachable & walk_ok
        delta = torch.where(pvalid & apply[:, None], -bottleneck[:, None], 0)
        residual.scatter_add_(1, psafe, delta)
        residual.scatter_add_(1, psafe ^ 1, -delta)
        remaining = torch.where(apply, remaining - bottleneck, remaining)
        nopath |= active & ~reachable
        walkfail |= active & reachable & ~walk_ok
    # reverse-lane residuals ARE the pushed flow per forward arc
    return residual[:, 1::2].contiguous(), remaining, nopath, walkfail


def tail_csr(i_src: torch.Tensor, n_arcs: int, n_pad: int):
    """Arcs 0 .. n_arcs - 1 grouped by tail node, ascending within a
    node: (offsets (n_pad + 1,) int32, arcs int32).  It depends on the
    topology alone; an arc past ``n_arcs`` must carry no residual in any
    query (the padding)."""
    tails = i_src[:n_arcs].long()
    order = torch.argsort(tails, stable=True)
    counts = torch.bincount(tails, minlength=n_pad)
    off = torch.zeros(n_pad + 1, dtype=torch.int64, device=i_src.device)
    off[1:] = torch.cumsum(counts, 0)
    return off.to(torch.int32), order.to(torch.int32)


def tail_order(i_dst: torch.Tensor, tail_arc: torch.Tensor):
    """The heads of the arcs by tail, (At,) int32, and each arc's place
    among them, (2 Af,) int32, -1 for an arc outside them: the kernel's
    tail-order operands, a function of the topology alone."""
    arc = tail_arc.long()
    pos = torch.full_like(i_dst, -1)
    pos[arc] = torch.arange(arc.numel(), dtype=torch.int32,
                            device=i_dst.device)
    return i_dst[arc].contiguous(), pos


def mcf_solve(i_src, i_dst, tail_off, tail_arc, tail_dst, tail_pos,
              fwd_cost, fwd_res, src, dst, amount, aug_cap, n_pad: int,
              work: list | None = None, _cluster: int | None = None):
    """R2 wrapper; operands and results as ``mcf_solve_plain``, plus the
    arcs by tail, ``tail_csr``'s pair, and their heads and each arc's
    place among them, ``tail_order``'s pair (``McfPlanes.device_arcs``
    gives all six topology operands).  The kernel reads all but i_dst:
    it copies each query's costs and residuals into tail order and
    relaxes a round's frontier there (the plain version sweeps every
    arc).  When `work` is a list, the kernel's (B, 3) int64 tensor of
    augmentations, rounds and frontier arcs visited a query is appended
    to it."""
    if not _on_card(fwd_cost):
        return mcf_solve_plain(i_src, i_dst, fwd_cost, fwd_res, src, dst,
                               amount, aug_cap, n_pad)
    B, Af = fwd_cost.shape
    if i_src.shape != (2 * Af,) or i_dst.shape != (2 * Af,) \
            or fwd_res.shape != (B, Af):
        raise ValueError("mcf_solve: arcs must be (2 Af,), lanes (B, Af)")
    if any(t.shape != (B,) for t in (src, dst, amount, aug_cap)):
        raise ValueError("mcf_solve: query lanes must be (B,)")
    At = tail_arc.shape[0]
    if tail_off.shape != (n_pad + 1,) or At > 2 * Af \
            or tail_dst.shape != (At,) or tail_pos.shape != (2 * Af,):
        raise ValueError("mcf_solve: tail_off must be (n_pad + 1,), "
                         "tail_arc and tail_dst (At <= 2 Af,), tail_pos "
                         "(2 Af,)")
    C = _cluster or R2_CLUSTER
    per, shift = split(n_pad, C)
    dv = fwd_cost.device
    i32, i64, u8, f64 = torch.int32, torch.int64, torch.uint8, torch.float64
    flow = torch.empty((B, Af), dtype=i64, device=dv)
    t_cost = torch.empty((B, At), dtype=f64, device=dv)
    t_res = torch.empty((B, At), dtype=i64, device=dv)
    remaining = torch.empty(B, dtype=i64, device=dv)
    nopath = torch.empty(B, dtype=u8, device=dv)
    walkfail = torch.empty(B, dtype=u8, device=dv)
    w = torch.empty((B, 3), dtype=i64, device=dv)
    # the node entries' global copy, read only when they are not shared
    dist = torch.empty((B, C * per), dtype=f64, device=dv)
    key = torch.empty((B, C * per), dtype=i64, device=dv)
    i32s = torch.empty((B, 4, C * per), dtype=i32, device=dv)
    ops = [i_src, tail_off, tail_arc, tail_dst, tail_pos, fwd_cost,
           fwd_res, flow, t_cost, t_res, src, dst, amount, aug_cap,
           remaining, nopath, walkfail, w, dist, key, i32s]
    kinds = [i32] * 5 + [f64, i64, i64, f64, i64, i32, i32, i64, i32, i64,
                         u8, u8, i64, f64, i64, i32]
    _launch("mcf_ssp", ops,
            [B, Af, At, n_pad, C, per, shift, int(r2_shared(per))], kinds)
    mcf_solve.launches += 1
    if work is not None:
        work.append(w)
    return flow, remaining, nopath.bool(), walkfail.bool()


mcf_solve.launches = 0

KERNELS = (route_sweep, mcf_solve)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
