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
// every round); the work is a dependent chain of rounds.  Design: the
// whole solve in one launch, a query on a thread block cluster, and work
// only where the reference's state can change:
//
// * A query runs on a cluster of C blocks (C = 1 .. 16), whose barrier
//   (barrier.cluster) separates the passes of a round.  Node v belongs
//   to block v / per of the cluster, which lists v in its frontier,
//   gives v its label and arc and keeps them: in its shared memory when
//   the query's entries fit the cluster's (`dsm`, 32 bytes a node; the
//   other blocks reach them through distributed shared memory,
//   cluster.cuh), else in global memory.  The default, 16 blocks with
//   the entries in shared memory (32 KB a block at 16,384 nodes), was
//   the fastest measured on the H100 (PERF.md section 6).
// * A round relaxes only the arcs leaving nodes whose label changed in
//   the round before (a frontier; the source in the first round).  An
//   arc from an unchanged node prices as it did the round before, when
//   it already lowered its head's label to at most its candidate, so it
//   cannot pass the `cand < dist[head] - eps` test; the reference's full
//   sweep finds it not better, and the frontier skips it.  A round with
//   an empty frontier changes nothing, and nor would the reference's
//   remaining rounds: the rounds stop there.
// * A round is three passes with a cluster barrier after each: (A) the
//   cluster's warps take the frontier nodes (every block's list, end to
//   end), a node a warp and its outgoing arcs a lane each; every arc
//   that is better than its head's label folds its candidate into the
//   head by atomicMin on the order-preserving key (routing.cuh mcf_key),
//   and the first arc to lower a head from +inf appends the head to its
//   owner's next frontier; (B) the better arcs whose candidate equals
//   that minimum (as doubles, -0.0 == 0.0) fold their index by
//   atomicMin; (C) each block's listed heads take the minimum and the
//   arc.  Labels are read by A and B and written by C alone (Jacobi).
// * Tail order.  A node's outgoing arcs are a contiguous range of the
//   arcs by tail (a CSR over the real arcs, built once per topology
//   revision, with their heads in the same order).  The launch first
//   copies each query's signed costs and residuals into that order, so a
//   warp's lanes read neighbouring addresses; the push finds an arc's
//   place by the inverse order, and the flows are copied back to the
//   canonical order at the end.  (Gathering the lanes through the arcs
//   by tail instead was slower at every cluster size measured on the
//   H100, PERF.md section 6.)
// * A query stops once it is inactive (nothing placed is left, its cap
//   is reached or a flag is set): the reference's later steps leave its
//   state as it is.
// * The walk and the push run on one thread of block 0, in the
//   reference's order.
#include <cuda_runtime.h>
#include <math.h>
#include "cluster.cuh"
#include "routing.cuh"

#define R2_THREADS 1024
#define R2_WARPS (R2_THREADS / 32)
#define R2_MAX_CLUSTER 16
#define MCF_ROUNDS 40        // routing/mcf.py MAX_ROUNDS
#define MCF_AUG_STEPS 64     // 4 * MAX_PARTS
#define MCF_WALK_CAP 64      // mcf_device.py WALK_CAP
#define MCF_EPS 1e-9

template <bool DSM>
__global__ void __launch_bounds__(R2_THREADS)
mcf_ssp_kernel(const int32_t *__restrict__ i_src,
               const int32_t *__restrict__ out_off,
               const int32_t *__restrict__ out_arc,
               const int32_t *__restrict__ t_dst,
               const int32_t *__restrict__ t_pos,
               const double *__restrict__ fwd_cost,
               const int64_t *__restrict__ fwd_res,
               int64_t *__restrict__ flow, double *__restrict__ t_cost,
               int64_t *__restrict__ t_res,
               const int32_t *__restrict__ src,
               const int32_t *__restrict__ dst,
               const int64_t *__restrict__ amount,
               const int32_t *__restrict__ aug_cap,
               int64_t *__restrict__ remaining_out,
               uint8_t *__restrict__ nopath_out,
               uint8_t *__restrict__ walkfail_out,
               int64_t *__restrict__ work_out, double *__restrict__ dist_s,
               uint64_t *__restrict__ key_s, int32_t *__restrict__ i32_s,
               int Af, int At, int n, int per, int shift) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gtid = rank * R2_THREADS + tid, gstride = C * R2_THREADS;
    const int lo = rank * per, np = C * per;
    const node_view<DSM> V = {rank, per, shift};
    // the query's signed costs and residuals by tail position
    double *cost_q = t_cost + (size_t)b * At;
    int64_t *res_q = t_res + (size_t)b * At;

    // this block's node range (index v - lo): float64 dist, key, int32
    // arc, pred; by position, the two frontier lists (list c at lists + c
    // * s32)
    double *dist;
    uint64_t *best;
    int32_t *l32;
    if (DSM) {
        extern __shared__ __align__(16) unsigned char smem[];
        dist = (double *)smem;
        best = (uint64_t *)(dist + per);
        l32 = (int32_t *)(best + per);
    } else {
        dist = dist_s + (size_t)b * np + lo;
        best = key_s + (size_t)b * np + lo;
        l32 = i32_s + (size_t)b * 4 * np + lo;
    }
    const size_t s32 = DSM ? per : np;
    int32_t *best_a = l32, *pred = l32 + s32, *lists = l32 + 2 * s32;
    const int s = src[b], d = dst[b], cap = aug_cap[b];
    const uint64_t KEY_INF = mcf_key(INFINITY);

    __shared__ int s_cnt[2];          // this block's frontier list sizes
    __shared__ int s_pref[R2_MAX_CLUSTER + 1];
    __shared__ int s_path[MCF_WALK_CAP];
    __shared__ long long s_remaining;
    __shared__ int s_nopath, s_walkfail;
    __shared__ unsigned long long s_relaxed;
    if (tid == 0) {
        s_remaining = amount[b];
        s_nopath = s_walkfail = 0;
        s_relaxed = 0;
    }
    // the query's lanes into tail order (reverse arcs start empty)
    for (int k = gtid; k < At; k += gstride) {
        const int a = out_arc[k];
        const double c = fwd_cost[(size_t)b * Af + (a >> 1)];
        cost_q[k] = (a & 1) ? -c : c;
        res_q[k] = (a & 1) ? 0 : fwd_res[(size_t)b * Af + (a >> 1)];
    }
    cluster.sync();

    long long *remaining0 = sh_of(&s_remaining, 0);
    int *nopath0 = sh_of(&s_nopath, 0), *walkfail0 = sh_of(&s_walkfail, 0);
    long long augs = 0, rounds = 0;
    unsigned long long relaxed = 0;
    for (int step = 0; step < MCF_AUG_STEPS; ++step) {
        if (!(vld(remaining0) > 0 && step < cap && !vld(nopath0)
              && !vld(walkfail0)))
            break;                                 // inactive for good
        ++augs;
        for (int i = tid; i < per; i += R2_THREADS) {
            dist[i] = INFINITY;
            pred[i] = -1;
            best[i] = KEY_INF;
            best_a[i] = RT_I32_MAX;
        }
        if (tid == 0) s_cnt[0] = s_cnt[1] = 0;
        __syncthreads();
        if (tid == 0 && (s >> shift) == rank) {
            dist[s - lo] = 0.0;
            lists[0] = s;
            s_cnt[0] = 1;
        }
        cluster.sync();
        for (int round = 0; round < MCF_ROUNDS; ++round) {
            const int cur = round & 1, nxt = cur ^ 1;
            int32_t *front = lists + cur * s32, *next = lists + nxt * s32;
            if (tid == 0) {
                int acc = 0;
                for (int r = 0; r < C; ++r) {
                    s_pref[r] = acc;
                    acc += vld(sh_of(&s_cnt[cur], r));
                }
                s_pref[C] = acc;
            }
            __syncthreads();
            const int total = s_pref[C];
            if (total == 0) break;                 // nothing changed
            ++rounds;
            // (A) candidate minimum of each head; first lowering lists it
            for (int i = rank * R2_WARPS + warp; i < total;
                 i += C * R2_WARPS) {
                int r = 0;
                while (s_pref[r + 1] <= i) ++r;
                const int u = V.ld(V.of_rank(front, r) + i - s_pref[r]);
                const double du = V.ld(V.at(dist, u));
                const int end = out_off[u + 1];
                for (int k = out_off[u] + lane; k < end; k += 32) {
                    ++relaxed;
                    if (ld_cg(res_q + k) <= 0) continue;
                    const double cand = du + ld_cg(cost_q + k);
                    const int v = t_dst[k];
                    if (cand < V.ld(V.at(dist, v)) - MCF_EPS
                        && V.amin(V.at(best, v), mcf_key(cand)) == KEY_INF) {
                        const int o = v >> shift;
                        const int pos = atomicAdd(sh_of(&s_cnt[nxt], o), 1);
                        V.of_rank(next, o)[pos] = v;
                    }
                }
            }
            cluster.sync();
            // (B) lowest arc index among the better arcs at the minimum
            for (int i = rank * R2_WARPS + warp; i < total;
                 i += C * R2_WARPS) {
                int r = 0;
                while (s_pref[r + 1] <= i) ++r;
                const int u = V.ld(V.of_rank(front, r) + i - s_pref[r]);
                const double du = V.ld(V.at(dist, u));
                const int end = out_off[u + 1];
                for (int k = out_off[u] + lane; k < end; k += 32) {
                    if (ld_cg(res_q + k) <= 0) continue;
                    const double cand = du + ld_cg(cost_q + k);
                    const int v = t_dst[k];
                    if (cand < V.ld(V.at(dist, v)) - MCF_EPS
                        && cand == mcf_unkey(V.ld(V.at(best, v))))
                        V.amin(V.at(best_a, v), out_arc[k]);
                }
            }
            cluster.sync();
            // (C) the listed heads take their minimum and arc
            const int nn = s_cnt[nxt];
            for (int p = tid; p < nn; p += R2_THREADS) {
                const int v = V.ld(next + p) - lo;
                dist[v] = mcf_unkey(V.ld(best + v));
                pred[v] = V.ld(best_a + v);
                best[v] = KEY_INF;
                best_a[v] = RT_I32_MAX;
            }
            if (tid == 0) s_cnt[cur] = 0;
            cluster.sync();
        }
        // the walk dst -> src and the bottleneck push, on one thread
        if (rank == 0 && tid == 0) {
            const bool reachable = isfinite(V.ld(V.at(dist, d)));
            long long bott = s_remaining;
            int v = d;
            for (int j = 0; j < MCF_WALK_CAP; ++j) {
                const int a = (v == s) ? -1 : V.ld(V.at(pred, v));
                s_path[j] = a;
                if (a >= 0) {
                    v = i_src[a];
                    const int64_t r = ld_cg(res_q + t_pos[a]);
                    if (r < bott) bott = r;
                }
            }
            const bool walk_ok = v == s;
            if (reachable && walk_ok) {
                for (int j = 0; j < MCF_WALK_CAP; ++j) {
                    const int a = s_path[j];
                    if (a < 0) continue;
                    int64_t *r = res_q + t_pos[a];
                    *r = ld_cg(r) - bott;
                }
                for (int j = 0; j < MCF_WALK_CAP; ++j) {
                    const int a = s_path[j];
                    if (a < 0) continue;
                    int64_t *r = res_q + t_pos[a ^ 1];
                    *r = ld_cg(r) + bott;
                }
                s_remaining -= bott;
            }
            if (!reachable) s_nopath = 1;
            if (reachable && !walk_ok) s_walkfail = 1;
        }
        cluster.sync();
    }
    if (relaxed) atomicAdd(&s_relaxed, relaxed);
    // the flows (the reverse arcs' residuals) back to canonical order
    for (int j = gtid; j < Af; j += gstride) {
        const int p = t_pos[2 * j + 1];
        flow[(size_t)b * Af + j] = p < 0 ? 0 : ld_cg(res_q + p);
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
        unsigned long long all = 0;
        for (int r = 0; r < C; ++r) all += vld(sh_of(&s_relaxed, r));
        remaining_out[b] = s_remaining;
        nopath_out[b] = (uint8_t)s_nopath;
        walkfail_out[b] = (uint8_t)s_walkfail;
        work_out[3 * b] = augs;
        work_out[3 * b + 1] = rounds;
        work_out[3 * b + 2] = (long long)all;
    }
    cluster.sync();     // every block's shared memory outlives rank 0's reads
}

typedef void (*r2_kernel_t)(
    const int32_t *, const int32_t *, const int32_t *, const int32_t *,
    const int32_t *, const double *, const int64_t *,
    int64_t *, double *, int64_t *, const int32_t *, const int32_t *,
    const int64_t *, const int32_t *, int64_t *, uint8_t *, uint8_t *,
    int64_t *, double *, uint64_t *, int32_t *, int, int, int, int, int);

static r2_kernel_t r2_kernel(int dsm) {
    return dsm ? mcf_ssp_kernel<true> : mcf_ssp_kernel<false>;
}

// Shared memory a block takes when the node entries live there.
static size_t r2_smem(int per) { return (size_t)per * (8 + 8 + 4 * 4); }

static int r2_config(r2_kernel_t kern, int C, int per, int dsm,
                     cudaLaunchConfig_t *cfg, cudaLaunchAttribute *attr) {
    const size_t smem = dsm ? r2_smem(per) : 0;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->blockDim = dim3(R2_THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return (int)err;
}

// Operands are contiguous CUDA buffers: i_src int32 (2 Af), the tails;
// out_off int32 (n + 1) and out_arc int32 (At), the arcs by tail; t_dst
// int32 (At), their heads, and t_pos int32 (2 Af), each arc's place in
// out_arc or -1; fwd_cost float64 (B, Af); fwd_res int64 (B, Af), the
// forward residuals; flow int64 (B, Af) out; scratch t_cost float64 and
// t_res int64 (B, At), the tail-order lanes; src, dst int32 (B); amount
// int64 (B); aug_cap int32 (B); outputs remaining int64 (B), nopath and
// walkfail uint8 (B), work int64 (B, 3): augmentations, rounds and
// frontier arcs visited; scratch dist float64 (B, C * per), key uint64
// (B, C * per), i32 int32 (B, 4, C * per), the node entries, read when
// dsm is 0.  C = cluster blocks a query, per = nodes a block (a power of
// two, C * per >= n), shift = log2(per); dsm 1 keeps the node entries in
// the blocks' shared memory instead, per * 32 bytes a block (the
// wrapper sets it where that fits).
extern "C" int mcf_ssp_launch(
    const void *i_src, const void *out_off, const void *out_arc,
    const void *t_dst, const void *t_pos, const void *fwd_cost,
    const void *fwd_res, void *flow, void *t_cost, void *t_res,
    const void *src, const void *dst, const void *amount,
    const void *aug_cap, void *remaining, void *nopath, void *walkfail,
    void *work, void *dist, void *key, void *i32s, int B, int Af, int At,
    int n, int C, int per, int shift, int dsm, void *stream) {
    if (B <= 0) return 0;
    if (C < 1 || C > R2_MAX_CLUSTER || (per & (per - 1)) || per < 1
        || (1 << shift) != per || (long long)C * per < n)
        return (int)cudaErrorInvalidValue;
    const r2_kernel_t kern = r2_kernel(dsm);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    const int err = r2_config(kern, C, per, dsm, &cfg, attr);
    if (err) return err;
    cfg.gridDim = dim3(B * C);
    cfg.stream = (cudaStream_t)stream;
    const cudaError_t launched = cudaLaunchKernelEx(
        &cfg, kern, (const int32_t *)i_src, (const int32_t *)out_off,
        (const int32_t *)out_arc, (const int32_t *)t_dst,
        (const int32_t *)t_pos, (const double *)fwd_cost,
        (const int64_t *)fwd_res, (int64_t *)flow,
        (double *)t_cost, (int64_t *)t_res, (const int32_t *)src,
        (const int32_t *)dst, (const int64_t *)amount,
        (const int32_t *)aug_cap, (int64_t *)remaining, (uint8_t *)nopath,
        (uint8_t *)walkfail, (int64_t *)work, (double *)dist,
        (uint64_t *)key, (int32_t *)i32s, Af, At, n, per, shift);
    if (launched != cudaSuccess) return (int)launched;
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM with its node entries in
// global memory.
extern "C" int mcf_ssp_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, mcf_ssp_kernel<false>, R2_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}

// Clusters of C blocks (per nodes a block, the entries in shared memory
// when dsm) the card can hold at once; -1 if it cannot hold one.
extern "C" int mcf_ssp_max_clusters(int C, int per, int dsm) {
    const r2_kernel_t kern = r2_kernel(dsm);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    if (r2_config(kern, C, per, dsm, &cfg, attr)) return -1;
    cfg.gridDim = dim3(C);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, (const void *)kern, &cfg)
        != cudaSuccess)
        return -1;
    return n;
}
