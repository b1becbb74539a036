// R2, the min-cost-flow solve: for each of B getroutes queries,
// successive shortest augmenting paths over the float64 residual graph
// (arc 2k forward, 2k+1 its reverse with cost -cost[k]): up to aug_cap
// augmentations, each MCF_ROUNDS Jacobi Bellman-Ford rounds from src with
// the 1e-9 tolerance and the lowest-arc-index tie-break, a walk of at
// most MCF_WALK_CAP predecessor arcs from dst back to src, and a
// bottleneck push into arcs a and a ^ 1.  Outputs the flow of every
// forward arc (its reverse arc's residual), the msat left unplaced and
// the no-path and walk-failure flags, the state of the JAX package's
// solve after all its steps.
//
// Replaces no pallas_call: in the JAX package this is an XLA program,
// lightning_tpu/routing/mcf_device.py _make_mcf_single (:419) under
// jax.jit(jax.vmap(...)) (_jit_mcf :514).  It is a hand kernel because
// its plain PyTorch version is tens of thousands of small launches a
// dispatch.  Bound: bytes (arc endpoints, costs and residuals read by
// every round); the work is a dependent chain of rounds.  Design: one
// block per query, the whole solve in one launch, and work only where
// the reference's state can change:
//
// * A round relaxes only the arcs leaving nodes whose label changed in
//   the round before (a frontier; the source in the first round).  An
//   arc from an unchanged node prices as it did the round before, when
//   it already lowered its head's label to at most its candidate, so it
//   cannot pass the `cand < dist[head] - eps` test; the reference's full
//   sweep finds it not better, and the frontier skips it.  A round with
//   an empty frontier changes nothing, and nor would the reference's
//   remaining rounds: the rounds stop there.
// * A round is three passes with a barrier after each: (A) every
//   frontier arc that is better than its head's label folds its
//   candidate into the head by atomicMin on the order-preserving key
//   (routing.cuh mcf_key), and the first arc to lower a head from +inf
//   appends the head to the next frontier; (B) the better arcs whose
//   candidate equals that minimum (as doubles, -0.0 == 0.0) fold their
//   index by atomicMin; (C) each head takes the minimum and the arc.
//   Labels are read by A and B and written by C alone (Jacobi).
// * A warp takes a frontier node, its lanes the node's outgoing arcs
//   (a CSR by tail over the real arcs, built once per topology
//   revision); the residual test skips those that carry nothing.
// * A query stops once it is inactive (nothing placed is left, its cap
//   is reached or a flag is set): the reference's later steps leave its
//   state as it is.
// * The walk and the push run on one thread, in the reference's order.
#include <cuda_runtime.h>
#include <math.h>
#include "routing.cuh"

#define R2_THREADS 1024
#define R2_WARPS (R2_THREADS / 32)
#define MCF_ROUNDS 40        // routing/mcf.py MAX_ROUNDS
#define MCF_AUG_STEPS 64     // 4 * MAX_PARTS
#define MCF_WALK_CAP 64      // mcf_device.py WALK_CAP
#define MCF_EPS 1e-9

struct mcf_query {
    const double *cost;      // (Af,) forward costs
    int64_t *fwd;            // (Af,) forward residuals (updated)
    int64_t *rev;            // (Af,) reverse residuals = flow (updated)
};

__device__ __forceinline__ int64_t residual(const mcf_query &q, int a) {
    return (a & 1) ? q.rev[a >> 1] : q.fwd[a >> 1];
}

__device__ __forceinline__ double arc_cost(const mcf_query &q, int a) {
    const double c = q.cost[a >> 1];
    return (a & 1) ? -c : c;
}

__global__ void __launch_bounds__(R2_THREADS)
mcf_ssp_kernel(const int32_t *__restrict__ i_src,
               const int32_t *__restrict__ i_dst,
               const int32_t *__restrict__ out_off,
               const int32_t *__restrict__ out_arc,
               const double *__restrict__ fwd_cost,
               int64_t *__restrict__ fwd_res, int64_t *__restrict__ flow,
               const int32_t *__restrict__ src,
               const int32_t *__restrict__ dst,
               const int64_t *__restrict__ amount,
               const int32_t *__restrict__ aug_cap,
               int64_t *__restrict__ remaining_out,
               uint8_t *__restrict__ nopath_out,
               uint8_t *__restrict__ walkfail_out,
               int64_t *__restrict__ work_out, double *__restrict__ dist_s,
               int32_t *__restrict__ pred_s,
               unsigned long long *__restrict__ key_s,
               int32_t *__restrict__ arc_s, int32_t *__restrict__ list_s,
               int Af, int n) {
    const int b = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const mcf_query q = {fwd_cost + (size_t)b * Af, fwd_res + (size_t)b * Af,
                         flow + (size_t)b * Af};
    double *dist = dist_s + (size_t)b * n;
    int32_t *pred = pred_s + (size_t)b * n;
    unsigned long long *best = key_s + (size_t)b * n;
    int32_t *best_a = arc_s + (size_t)b * n;
    int32_t *lists[2] = {list_s + (size_t)b * 2 * n,
                         list_s + (size_t)b * 2 * n + n};
    const int s = src[b], d = dst[b], cap = aug_cap[b];
    const unsigned long long KEY_INF = mcf_key(INFINITY);

    __shared__ int s_count[2];
    __shared__ int s_path[MCF_WALK_CAP];
    __shared__ long long s_remaining;
    __shared__ int s_nopath, s_walkfail;
    __shared__ unsigned long long s_relaxed;
    if (tid == 0) {
        s_remaining = amount[b];
        s_nopath = s_walkfail = 0;
        s_relaxed = 0;
    }
    __syncthreads();

    long long augs = 0, rounds = 0;
    for (int step = 0; step < MCF_AUG_STEPS; ++step) {
        if (!(s_remaining > 0 && step < cap && !s_nopath && !s_walkfail))
            break;                                 // inactive for good
        ++augs;
        for (int v = tid; v < n; v += R2_THREADS) {
            dist[v] = INFINITY;
            pred[v] = -1;
            best[v] = KEY_INF;
            best_a[v] = RT_I32_MAX;
        }
        __syncthreads();
        if (tid == 0) {
            dist[s] = 0.0;
            lists[0][0] = s;
        }
        int nf = 1, cur = 0;
        for (int round = 0; round < MCF_ROUNDS && nf > 0; ++round) {
            const int32_t *frontier = lists[cur];
            int32_t *next = lists[cur ^ 1];
            if (tid == 0) s_count[cur ^ 1] = 0;
            __syncthreads();
            // (A) candidate minimum of each head; first lowering lists it
            unsigned long long relaxed = 0;
            for (int i = warp; i < nf; i += R2_WARPS) {
                const int u = frontier[i];
                const double du = dist[u];
                for (int k = out_off[u] + lane; k < out_off[u + 1];
                     k += 32) {
                    const int a = out_arc[k];
                    ++relaxed;
                    if (residual(q, a) <= 0) continue;
                    const double cand = du + arc_cost(q, a);
                    const int v = i_dst[a];
                    if (cand < dist[v] - MCF_EPS) {
                        if (atomicMin(&best[v], mcf_key(cand)) == KEY_INF)
                            next[atomicAdd(&s_count[cur ^ 1], 1)] = v;
                    }
                }
            }
            if (relaxed) atomicAdd(&s_relaxed, relaxed);
            __syncthreads();
            // (B) lowest arc index among the better arcs at the minimum
            for (int i = warp; i < nf; i += R2_WARPS) {
                const int u = frontier[i];
                const double du = dist[u];
                for (int k = out_off[u] + lane; k < out_off[u + 1];
                     k += 32) {
                    const int a = out_arc[k];
                    if (residual(q, a) <= 0) continue;
                    const double cand = du + arc_cost(q, a);
                    const int v = i_dst[a];
                    if (cand < dist[v] - MCF_EPS
                        && cand == mcf_unkey(best[v]))
                        atomicMin(&best_a[v], a);
                }
            }
            __syncthreads();
            // (C) the listed heads take their minimum and arc
            const int nn = s_count[cur ^ 1];
            for (int i = tid; i < nn; i += R2_THREADS) {
                const int v = next[i];
                dist[v] = mcf_unkey(best[v]);
                pred[v] = best_a[v];
                best[v] = KEY_INF;
                best_a[v] = RT_I32_MAX;
            }
            __syncthreads();
            nf = nn;
            cur ^= 1;
            ++rounds;
        }
        // the walk dst -> src and the bottleneck push, on one thread
        if (tid == 0) {
            const bool reachable = isfinite(dist[d]);
            long long bott = s_remaining;
            int v = d;
            for (int j = 0; j < MCF_WALK_CAP; ++j) {
                const int a = (v == s) ? -1 : pred[v];
                s_path[j] = a;
                if (a >= 0) {
                    v = i_src[a];
                    const int64_t r = residual(q, a);
                    if (r < bott) bott = r;
                }
            }
            const bool walk_ok = v == s;
            if (reachable && walk_ok) {
                for (int j = 0; j < MCF_WALK_CAP; ++j) {
                    const int a = s_path[j];
                    if (a < 0) continue;
                    if (a & 1) q.rev[a >> 1] -= bott;
                    else q.fwd[a >> 1] -= bott;
                }
                for (int j = 0; j < MCF_WALK_CAP; ++j) {
                    const int a = s_path[j] ^ 1;
                    if (s_path[j] < 0) continue;
                    if (a & 1) q.rev[a >> 1] += bott;
                    else q.fwd[a >> 1] += bott;
                }
                s_remaining -= bott;
            }
            if (!reachable) s_nopath = 1;
            if (reachable && !walk_ok) s_walkfail = 1;
        }
        __syncthreads();
    }
    if (tid == 0) {
        remaining_out[b] = s_remaining;
        nopath_out[b] = (uint8_t)s_nopath;
        walkfail_out[b] = (uint8_t)s_walkfail;
        work_out[3 * b] = augs;
        work_out[3 * b + 1] = rounds;
        work_out[3 * b + 2] = (long long)s_relaxed;
    }
}

// Operands are contiguous CUDA buffers: i_src, i_dst int32 (2 Af);
// out_off int32 (n + 1) and out_arc int32, the arcs by tail; fwd_cost
// float64 (B, Af); fwd_res int64 (B, Af), the forward residuals, updated
// in place; flow int64 (B, Af), zero on entry; src, dst int32 (B); amount
// int64 (B); aug_cap int32 (B); outputs remaining int64 (B), nopath and
// walkfail uint8 (B), work int64 (B, 3): augmentations, rounds and
// frontier arcs visited; scratch dist float64 (B, n), pred int32 (B, n),
// key uint64 (B, n), arc int32 (B, n), lists int32 (B, 2, n).
extern "C" int mcf_ssp_launch(
    const void *i_src, const void *i_dst, const void *out_off,
    const void *out_arc, const void *fwd_cost, void *fwd_res, void *flow,
    const void *src, const void *dst, const void *amount,
    const void *aug_cap, void *remaining, void *nopath, void *walkfail,
    void *work, void *dist, void *pred, void *key, void *arc, void *lists,
    int B, int Af, int n, void *stream) {
    if (B <= 0) return 0;
    mcf_ssp_kernel<<<B, R2_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t *)i_src, (const int32_t *)i_dst,
        (const int32_t *)out_off, (const int32_t *)out_arc,
        (const double *)fwd_cost, (int64_t *)fwd_res, (int64_t *)flow,
        (const int32_t *)src, (const int32_t *)dst, (const int64_t *)amount,
        (const int32_t *)aug_cap, (int64_t *)remaining, (uint8_t *)nopath,
        (uint8_t *)walkfail, (int64_t *)work, (double *)dist,
        (int32_t *)pred, (unsigned long long *)key, (int32_t *)arc,
        (int32_t *)lists, Af, n);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int mcf_ssp_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, mcf_ssp_kernel, R2_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}
