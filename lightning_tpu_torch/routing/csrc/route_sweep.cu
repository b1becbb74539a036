// R1, the route sweep: for each of B getroute queries, max_hops Jacobi
// Bellman-Ford sweeps backward from the query's destination over the
// route planes, with dijkstra's exact int64 cost model (routing.cuh
// rt_price).  Outputs each query's cost label at its source, the winning
// edge of every node (via) and the overflow flag.
//
// Replaces no pallas_call: in the JAX package this is an XLA program,
// lightning_tpu/routing/device.py _make_single (:144) under
// jax.jit(jax.vmap(...)) (_jit_route :203).  It is a hand kernel because
// its plain PyTorch version is about 25 elementwise, gather and scatter
// launches a sweep.  Bound: bytes (the planes, the query's edge mask and
// the gathered node labels of every sweep; a few int64 products and
// divisions an edge).  Design: one block per query, all sweeps in one
// launch.  A sweep is three passes over the block with a barrier after
// each: (A) every edge prices itself against the previous sweep's labels
// and folds its cost into its forwarding node by atomicMin; (B) the
// edges whose cost equals their node's minimum fold their index by
// atomicMin (lowest edge index wins a tie); (C) every node whose minimum
// is strictly below its label takes the winning edge's labels.  The
// amount and delay labels ping-pong between two buffers, so pass C reads
// only the previous sweep's (Jacobi, as the reference); the cost label
// is read by passes A and B and written by C alone.  The planes (48
// bytes an edge) are shared by the queries and stay in L2.
#include <cuda_runtime.h>
#include "routing.cuh"

#define R1_THREADS 1024

__global__ void __launch_bounds__(R1_THREADS)
route_sweep_kernel(const int32_t *__restrict__ edge_src,
                   const int32_t *__restrict__ edge_dst,
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
                   uint8_t *__restrict__ ovf, int64_t *__restrict__ scratch,
                   int32_t *__restrict__ scratch_e, int E, int n,
                   int max_hops) {
    const int q = blockIdx.x, tid = threadIdx.x;
    const uint8_t *ok_q = edge_ok + (size_t)q * E;
    int64_t *dist = scratch + (size_t)q * 6 * n;
    int64_t *amt[2] = {dist + n, dist + 2 * (size_t)n};
    int64_t *dly[2] = {dist + 3 * (size_t)n, dist + 4 * (size_t)n};
    int64_t *best = dist + 5 * (size_t)n;
    int32_t *best_e = scratch_e + (size_t)q * n;
    int32_t *via_q = via + (size_t)q * n;
    const int64_t rf = riskfactor[q];
    __shared__ int s_ovf;

    for (int v = tid; v < n; v += R1_THREADS) {
        dist[v] = RT_INF_COST;
        amt[0][v] = 0;
        dly[0][v] = 0;
        via_q[v] = -1;
        best[v] = RT_I64_MAX;
        best_e[v] = RT_I32_MAX;
    }
    if (tid == 0) s_ovf = 0;
    __syncthreads();
    if (tid == 0) {
        dist[dst[q]] = 0;
        amt[0][dst[q]] = amount[q];
        dly[0][dst[q]] = final_cltv[q];
    }
    __syncthreads();

    int cur = 0, ovf_t = 0;
    for (int h = 0; h < max_hops; ++h) {
        const int64_t *amt_c = amt[cur], *dly_c = dly[cur];
        int64_t *amt_n = amt[cur ^ 1], *dly_n = dly[cur ^ 1];
        // (A) cost minimum of each forwarding node
        for (int e = tid; e < E; e += R1_THREADS) {
            if (!ok_q[e]) continue;
            const int v = edge_dst[e];
            const int64_t cdr = cd[e] * rf;
            int64_t cand, fee;
            if (rt_price(dist[v], amt_c[v], 1, base[e], ppm[e], hmin[e],
                         hmax[e], cdr, rt_threshold(ppm[e], cdr), &cand,
                         &fee, &ovf_t))
                atomicMin((long long *)&best[edge_src[e]], (long long)cand);
        }
        __syncthreads();
        // (B) lowest edge index among the edges at that minimum
        for (int e = tid; e < E; e += R1_THREADS) {
            if (!ok_q[e]) continue;
            const int v = edge_dst[e];
            const int u = edge_src[e];
            const int64_t cdr = cd[e] * rf;
            int64_t cand, fee;
            int unused = 0;
            if (rt_price(dist[v], amt_c[v], 1, base[e], ppm[e], hmin[e],
                         hmax[e], cdr, rt_threshold(ppm[e], cdr), &cand,
                         &fee, &unused)
                && cand == best[u])
                atomicMin(&best_e[u], e);
        }
        __syncthreads();
        // (C) strictly cheaper labels take the winning edge
        for (int v = tid; v < n; v += R1_THREADS) {
            const int64_t b = best[v];
            if (b < dist[v]) {
                const int e = best_e[v];
                const int w = edge_dst[e];
                const int64_t a_w = amt_c[w];
                dist[v] = b;
                amt_n[v] = a_w + base[e] + (a_w * ppm[e]) / 1000000;
                dly_n[v] = dly_c[w] + cd[e];
                via_q[v] = e;
            } else {
                amt_n[v] = amt_c[v];
                dly_n[v] = dly_c[v];
            }
            best[v] = RT_I64_MAX;
            best_e[v] = RT_I32_MAX;
        }
        __syncthreads();
        cur ^= 1;
    }
    if (ovf_t) s_ovf = 1;
    __syncthreads();
    if (tid == 0) {
        dist_src[q] = dist[src[q]];
        ovf[q] = (uint8_t)s_ovf;
    }
}

// Operands are contiguous CUDA buffers: edge_src, edge_dst int32 (E);
// base, ppm, cd, hmin, hmax int64 (E); edge_ok uint8 (B, E); src, dst
// int32 (B); amount, final_cltv, riskfactor int64 (B); outputs dist_src
// int64 (B), via int32 (B, n), ovf uint8 (B); scratch int64 (B, 6, n) and
// scratch_e int32 (B, n).
extern "C" int route_sweep_launch(
    const void *edge_src, const void *edge_dst, const void *base,
    const void *ppm, const void *cd, const void *hmin, const void *hmax,
    const void *edge_ok, const void *src, const void *dst,
    const void *amount, const void *final_cltv, const void *riskfactor,
    void *dist_src, void *via, void *ovf, void *scratch, void *scratch_e,
    int B, int E, int n, int max_hops, void *stream) {
    if (B <= 0) return 0;
    route_sweep_kernel<<<B, R1_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t *)edge_src, (const int32_t *)edge_dst,
        (const int64_t *)base, (const int64_t *)ppm, (const int64_t *)cd,
        (const int64_t *)hmin, (const int64_t *)hmax,
        (const uint8_t *)edge_ok, (const int32_t *)src,
        (const int32_t *)dst, (const int64_t *)amount,
        (const int64_t *)final_cltv, (const int64_t *)riskfactor,
        (int64_t *)dist_src, (int32_t *)via, (uint8_t *)ovf,
        (int64_t *)scratch, (int32_t *)scratch_e, E, n, max_hops);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int route_sweep_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, route_sweep_kernel, R1_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}
