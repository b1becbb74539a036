// R1, the route sweep: for each of B getroute queries, Jacobi
// Bellman-Ford sweeps backward from the query's destination over the
// route planes, at most max_hops of them, with dijkstra's exact int64
// cost model (routing.cuh rt_price).  Outputs each query's cost label at
// its source, the winning edge of every node (via), the overflow flag
// and the work done (sweeps run, edges priced).
//
// Replaces no pallas_call: in the JAX package this is an XLA program,
// lightning_tpu/routing/device.py _make_single (:144) under
// jax.jit(jax.vmap(...)) (_jit_route :203), which prices every edge in
// every one of max_hops sweeps.  It is a hand kernel because its plain
// PyTorch version is about 25 elementwise, gather and scatter launches a
// sweep.  Bound: bytes (the planes, the query's edge mask and the labels
// the frontier reads); the work is a dependent chain of short sweeps.
// Design:
//
// * A query runs on a thread block cluster of C blocks (C = 1 .. 16),
//   whose barrier (barrier.cluster) separates the passes of a sweep.
//   Node v belongs to block v / per of the cluster (per = the nodes a
//   block), which lists v in its frontier and gives v its new labels.
//   The labels live in global memory (the query's scratch), read past
//   the SM's L1 (cluster.cuh).  The default, 1,024 threads a block and
//   two blocks a query, was the fastest of the sizes and block widths
//   measured on the H100 (PERF.md section 6): 64 queries are one wave of
//   64 clusters.  (At 16,384 nodes a query's 60 bytes a node fit the
//   cluster's shared memory only from 8 blocks, which was slower.)
// * Frontier.  Sweep h prices only the in-edges of the nodes whose label
//   changed in sweep h - 1 (sweep 0: the destination), a contiguous range
//   of the destination-keyed CSR (in_off).  The launch stops at the first
//   sweep that changes nothing, or after max_hops.  This gives the full
//   sweep's labels, via and overflow flag, because:
//   - an edge u -> v whose head v did not change since it was last
//     priced prices as it did then; that pricing folded its candidate
//     into u, so u's label has been at or below the candidate since
//     (labels only fall).  It can neither lower u's label nor tie a
//     new, strictly lower minimum, so the lowest-index tie-break among
//     the edges at that minimum picks the same edge as the full sweep;
//     an edge whose head never changed has an unreached head and is not
//     priced by the full sweep either;
//   - the sticky overflow flag depends on the head's labels alone, so
//     it is set the first time such an edge is priced, in the sweep
//     where the full sweep first sets it;
//   - a sweep that changes no label leaves the next sweep's inputs as
//     they were, so every later sweep is a no-op too.
// * A sweep is three passes, a cluster barrier after each:
//   (A) the cluster's warps take the frontier nodes (every block's
//   list, end to end), a node a warp and its in-edges a lane each; an
//   edge that relaxes to below its tail's label folds its candidate into
//   the tail by atomicMin, the first such edge lists the tail in its
//   owner's next frontier, and an edge at or below the minimum it found
//   goes on the query's work list with its candidate;
//   (B) the work list's edges whose candidate equals their tail's
//   minimum fold their index by atomicMin (lowest index wins a tie):
//   no edge is priced twice;
//   (C) each block gives its listed nodes the minimum, the winning edge
//   and the amount and delay through it.
// * Jacobi labels.  Pass C reads the winning head's amount and delay as
//   they were before the sweep, though the head may change in the same
//   sweep: the new amount and delay are staged by list position and
//   written into the labels by the owner at the start of the next pass
//   A, which reads them from the stage.
// * No int64 division by a variable: the overflow guard compares 128-bit
//   products (routing.cuh rt_unsafe); the price divides by the constants
//   10^6 and 5,259,600 only.
#include <cuda_runtime.h>
#include "cluster.cuh"
#include "routing.cuh"

#define R1_THREADS 1024
#define R1_WARPS (R1_THREADS / 32)
#define R1_MAX_CLUSTER 16

__global__ void __launch_bounds__(R1_THREADS)
route_sweep_kernel(const int32_t *__restrict__ edge_src,
                   const int32_t *__restrict__ edge_dst,
                   const int32_t *__restrict__ in_off,
                   const int64_t *__restrict__ base,
                   const int64_t *__restrict__ ppm,
                   const int64_t *__restrict__ cd,
                   const int64_t *__restrict__ hmin,
                   const int64_t *__restrict__ hmax,
                   const uint8_t *__restrict__ edge_ok,
                   const int32_t *__restrict__ src,
                   const int32_t *__restrict__ dst,
                   const int64_t *__restrict__ amount,
                   const int64_t *__restrict__ final_cltv,
                   const int64_t *__restrict__ riskfactor,
                   int64_t *__restrict__ dist_src, int32_t *__restrict__ via,
                   uint8_t *__restrict__ ovf, int64_t *__restrict__ work,
                   int64_t *__restrict__ scratch,
                   int32_t *__restrict__ scratch_e,
                   int32_t *__restrict__ wl_e, int64_t *__restrict__ wl_c,
                   int E, int n, int per, int shift, int max_hops) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int q = blockIdx.x / C, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int lo = rank * per, np = C * per;
    const node_view<false> V = {rank, per, shift};

    // this block's node range (index v - lo): int64 dist, amt, dly, best;
    // int32 best edge; by list position: int64 staged amt and delay, int32
    // the two frontier lists (list c at lists + c * np)
    int64_t *l64 = scratch + (size_t)q * 6 * np + lo;
    int32_t *l32 = scratch_e + (size_t)q * 3 * np + lo;
    int64_t *dist = l64, *amt = l64 + np, *dly = l64 + 2 * np;
    int64_t *best = l64 + 3 * np, *st_amt = l64 + 4 * np;
    int64_t *st_dly = l64 + 5 * np;
    int32_t *best_e = l32, *lists = l32 + np;

    const uint8_t *ok_q = edge_ok + (size_t)q * E;
    int32_t *via_q = via + (size_t)q * n;
    int32_t *wle = wl_e + (size_t)q * E;
    int64_t *wlc = wl_c + (size_t)q * E;
    const int64_t rf = riskfactor[q];

    __shared__ int s_cnt[2];          // this block's frontier list sizes
    __shared__ int s_work;            // the query's work list (rank 0's)
    __shared__ int s_pref[R1_MAX_CLUSTER + 1];
    __shared__ int s_ovf;
    __shared__ unsigned long long s_priced;

    for (int i = tid; i < per; i += R1_THREADS) {
        dist[i] = RT_INF_COST;
        best[i] = RT_I64_MAX;
        best_e[i] = RT_I32_MAX;
        if (lo + i < n) via_q[lo + i] = -1;
    }
    if (tid == 0) {
        s_cnt[0] = s_cnt[1] = 0;
        s_work = 0;
        s_ovf = 0;
        s_priced = 0;
    }
    __syncthreads();
    const int d = dst[q];
    if (tid == 0 && (d >> shift) == rank) {
        dist[d - lo] = 0;
        lists[0] = d;
        st_amt[0] = amount[q];
        st_dly[0] = final_cltv[q];
        s_cnt[0] = 1;
    }
    cluster.sync();

    int *work_n = sh_of(&s_work, 0);
    int ovf_t = 0, sweeps = 0;
    unsigned long long priced = 0;
    for (int h = 0; h < max_hops; ++h) {
        const int cur = h & 1, nxt = cur ^ 1;
        int32_t *front = lists + cur * np, *next = lists + nxt * np;
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
        if (total == 0) break;                    // the fixed point
        ++sweeps;
        // the owner moves its frontier's staged labels into place
        const int own = s_cnt[cur];
        for (int p = tid; p < own; p += R1_THREADS) {
            const int v = V.ld(front + p) - lo;
            amt[v] = V.ld(st_amt + p);
            dly[v] = V.ld(st_dly + p);
        }
        // (A) price the frontier's in-edges
        for (int i = rank * R1_WARPS + warp; i < total;
             i += C * R1_WARPS) {
            int r = 0;
            while (s_pref[r + 1] <= i) ++r;
            const int p = i - s_pref[r];
            const int v = V.ld(V.of_rank(front, r) + p);
            const int64_t d_v = V.ld(V.at(dist, v));
            const int64_t a_v = V.ld(V.of_rank(st_amt, r) + p);
            const int beg = in_off[v], end = in_off[v + 1];
            for (int e0 = beg; e0 < end; e0 += 32) {
                const int e = e0 + lane;
                bool push = false;
                int64_t cand = 0;
                if (e < end) {
                    ++priced;
                    int64_t fee;
                    if (ok_q[e]
                        && rt_price(d_v, a_v, 1, base[e], ppm[e], hmin[e],
                                    hmax[e], cd[e] * rf, &cand, &fee,
                                    &ovf_t)) {
                        const int u = edge_src[e];
                        if (cand < V.ld(V.at(dist, u))) {
                            const int64_t old = V.amin(V.at(best, u), cand);
                            if (old == RT_I64_MAX) {
                                const int o = u >> shift;
                                const int pos = atomicAdd(
                                    sh_of(&s_cnt[nxt], o), 1);
                                V.of_rank(next, o)[pos] = u;
                            }
                            push = cand <= old;
                        }
                    }
                }
                const unsigned m = __ballot_sync(0xffffffffu, push);
                if (m) {
                    int at0 = 0;
                    if (lane == 0) at0 = atomicAdd(work_n, __popc(m));
                    at0 = __shfl_sync(0xffffffffu, at0, 0);
                    if (push) {
                        const int k = at0 + __popc(m & ((1u << lane) - 1));
                        wle[k] = e;
                        wlc[k] = cand;
                    }
                }
            }
        }
        cluster.sync();
        // (B) the lowest edge index among the edges at the minimum
        const int nw = vld(work_n);
        for (int k = rank * R1_THREADS + tid; k < nw;
             k += C * R1_THREADS) {
            const int e = ld_cg(wle + k);
            const int u = edge_src[e];
            if (ld_cg(wlc + k) == V.ld(V.at(best, u)))
                V.amin(V.at(best_e, u), e);
        }
        cluster.sync();
        // (C) the listed nodes take the minimum and the winning edge; the
        // head's amount and delay are the labels before this sweep
        const int nn = s_cnt[nxt];
        for (int p = tid; p < nn; p += R1_THREADS) {
            const int u = V.ld(next + p), iu = u - lo;
            const int e = V.ld(best_e + iu);
            const int w = edge_dst[e];
            const int64_t a_w = V.ld(V.at(amt, w));
            dist[iu] = V.ld(best + iu);
            st_amt[p] = a_w + base[e] + (a_w * ppm[e]) / 1000000;
            st_dly[p] = V.ld(V.at(dly, w)) + cd[e];
            via_q[u] = e;
            best[iu] = RT_I64_MAX;
            best_e[iu] = RT_I32_MAX;
        }
        if (tid == 0) {
            s_cnt[cur] = 0;
            if (rank == 0) s_work = 0;
        }
        cluster.sync();
    }

    if (ovf_t) s_ovf = 1;
    for (int o = 16; o > 0; o >>= 1)
        priced += __shfl_xor_sync(0xffffffffu, priced, o);
    if (lane == 0 && priced) atomicAdd(&s_priced, priced);
    cluster.sync();
    if (rank == 0 && tid == 0) {
        int any = 0;
        unsigned long long all = 0;
        for (int r = 0; r < C; ++r) {
            any |= vld(sh_of(&s_ovf, r));
            all += vld(sh_of(&s_priced, r));
        }
        dist_src[q] = V.ld(V.at(dist, src[q]));
        ovf[q] = (uint8_t)(any != 0);
        work[2 * q] = sweeps;
        work[2 * q + 1] = (int64_t)all;
    }
    cluster.sync();     // every block's shared memory outlives rank 0's reads
}

static int r1_config(int C, cudaLaunchConfig_t *cfg,
                     cudaLaunchAttribute *attr) {
    cudaError_t err = cudaSuccess;
    if (C > 8)
        err = cudaFuncSetAttribute(
            route_sweep_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->blockDim = dim3(R1_THREADS);
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return (int)err;
}

// Operands are contiguous CUDA buffers: edge_src, edge_dst int32 (E),
// edges sorted by edge_dst; in_off int32 (n + 1), the in-edges of v being
// in_off[v] .. in_off[v + 1] - 1 (an edge outside every range must be off
// in edge_ok); base, ppm, cd, hmin, hmax int64 (E); edge_ok uint8 (B, E);
// src, dst int32 (B); amount, final_cltv, riskfactor int64 (B); outputs
// dist_src int64 (B), via int32 (B, n), ovf uint8 (B), work int64 (B, 2):
// sweeps run and edges priced; scratch int64 (B, 6, C * per) and
// scratch_e int32 (B, 3, C * per), the labels; the work list wl_e int32
// (B, E), wl_c int64 (B, E).  C = cluster blocks a query, per = nodes a
// block (a power of two, C * per >= n), shift = log2(per).
extern "C" int route_sweep_launch(
    const void *edge_src, const void *edge_dst, const void *in_off,
    const void *base, const void *ppm, const void *cd, const void *hmin,
    const void *hmax, const void *edge_ok, const void *src, const void *dst,
    const void *amount, const void *final_cltv, const void *riskfactor,
    void *dist_src, void *via, void *ovf, void *work, void *scratch,
    void *scratch_e, void *wl_e, void *wl_c, int B, int E, int n,
    int max_hops, int C, int per, int shift, void *stream) {
    if (B <= 0) return 0;
    if (C < 1 || C > R1_MAX_CLUSTER || (per & (per - 1)) || per < 1
        || (1 << shift) != per || (long long)C * per < n)
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    const int err = r1_config(C, &cfg, attr);
    if (err) return err;
    cfg.gridDim = dim3(B * C);
    cfg.stream = (cudaStream_t)stream;
    const cudaError_t launched = cudaLaunchKernelEx(
        &cfg, route_sweep_kernel, (const int32_t *)edge_src,
        (const int32_t *)edge_dst, (const int32_t *)in_off,
        (const int64_t *)base, (const int64_t *)ppm, (const int64_t *)cd,
        (const int64_t *)hmin, (const int64_t *)hmax,
        (const uint8_t *)edge_ok, (const int32_t *)src,
        (const int32_t *)dst, (const int64_t *)amount,
        (const int64_t *)final_cltv, (const int64_t *)riskfactor,
        (int64_t *)dist_src, (int32_t *)via, (uint8_t *)ovf,
        (int64_t *)work, (int64_t *)scratch, (int32_t *)scratch_e,
        (int32_t *)wl_e, (int64_t *)wl_c, E, n, per, shift, max_hops);
    if (launched != cudaSuccess) return (int)launched;
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM.
extern "C" int route_sweep_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, route_sweep_kernel, R1_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}

// Clusters of C blocks the card can hold at once; -1 if it cannot hold
// one.
extern "C" int route_sweep_max_clusters(int C) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    if (r1_config(C, &cfg, attr)) return -1;
    cfg.gridDim = dim3(C);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, (const void *)route_sweep_kernel,
                                       &cfg) != cudaSuccess)
        return -1;
    return n;
}
