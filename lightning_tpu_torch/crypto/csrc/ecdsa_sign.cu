// S2, the ECDSA sign kernel, templated on the candidate count C: for each
// row, r and s of the signature of hash z by key d with the first of C
// nonce candidates whose r is low (bit 255 clear) and nonzero, else with
// candidate 0; s low-S normalized; ok (r and s nonzero) and grind (a
// low-R candidate was found) as bytes.  C = 4 is hsmd's grinding signer,
// C = 1 the bulk signer of the synthetic store.
//
// Replaces no pallas_call: in the JAX package these are XLA programs,
// lightning_tpu/crypto/secp256k1.py ecdsa_sign_kernel (:405, C =
// GRIND_CANDIDATES = 4) and ecdsa_sign_simple_kernel (:437, C = 1).  A
// hand kernel because the plain PyTorch version is a few thousand small
// launches a batch.  Bound: 32-bit integer multiply-adds, a comb k*G per
// candidate tried (on random nonces 1 + 1/2 + 1/4 + 1/8 = 1.875 of 4 on
// average), the products of the two batch inversions and 1/S2_THREADS of
// their Fermat chains; 160 bytes a row of operands (C = 4) and the 60 KB
// table are small beside them.
//
// Design: a block signs a tile of rows in candidate rounds (sign_tile in
// secp256k1.cuh).  Round c computes k*G only for the rows still pending,
// packed onto the low threads by a block-wide ballot prefix sum; a warp
// with no job skips the round, and where fewer rows are pending than the
// block has threads, the threads above take the rows' next candidates
// (fill), so a small batch tries all its candidates in one round.  Each
// round's x = X / Z is one batch inversion mod p over the block
// (Montgomery's trick: warp scans, one Fermat chain on thread 0), and k^-1
// mod n of the chosen candidates one more, mod n.  The grid is sized from
// the occupancy query: at most the blocks the card holds at once, each
// looping over tiles, and the rows a tile from the batch, so that a batch
// smaller than the card spreads a few rows a block over every SM and
// tries all its candidates in the first round.  z, d, the candidates
// (C, 8, B), r and s are planes with the batch fastest; the table is read
// through the read-only cache (a copy in shared memory, as S1 keeps one,
// measured no faster here).
//
// One block an SM (__launch_bounds__ with 1: at most 128 registers a
// thread).  kernel_ablation.py timed each step of this design against the
// one before it (PERF.md).
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define S2_THREADS 512       // threads a block, rows a tile at most
#define S2_WARPS (S2_THREADS / 32)

struct s2_smem {
    sign_tile<S2_THREADS> tile;
    block_inv_smem<S2_WARPS> inv;
    int warp_pending[S2_WARPS];
};

// Pack the rows still pending (pend) onto list[0, p) in thread order: a
// ballot within each warp, the warps' counts through shared memory.
__device__ __forceinline__ void compact(s2_smem &sm, uint32_t pend,
                                        int row) {
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    const uint32_t mask = __ballot_sync(0xFFFFFFFFu, pend);
    if (lane == 0) sm.warp_pending[wid] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < S2_WARPS; w++) {
        const int c = sm.warp_pending[w];
        off += w < wid ? c : 0;
        total += c;
    }
    if (pend)
        sm.tile.list[off + __popc(mask & ((1u << lane) - 1u))] =
            (uint16_t)row;
    if (t == 0) sm.tile.p = total;
    __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(S2_THREADS, 1)
ecdsa_sign_kernel(const uint32_t *__restrict__ z,
                  const uint32_t *__restrict__ d,
                  const uint32_t *__restrict__ ks,
                  const uint32_t *__restrict__ comb,
                  uint32_t *__restrict__ out_r, uint32_t *__restrict__ out_s,
                  uint8_t *__restrict__ out_ok,
                  uint8_t *__restrict__ out_grind, int B, int rows) {
    __shared__ s2_smem sm;
    sign_tile<S2_THREADS> &s = sm.tile;
    const int t = threadIdx.x;
    const int tiles = (B + rows - 1) / rows;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int base = tile * rows;
        const int n = B - base < rows ? B - base : rows;
        sign_tile_start(s, t, n);
        __syncthreads();
#pragma unroll 1
        for (int round = 0; round < C; round++) {
            const int p = s.p;
            if (p == 0) break;
            int cand = 0;
            const int row = sign_job<C>(s, t, p, cand);
            const bool job = row >= 0;
            pt acc;
            uint32_t zi[8];
            if (job) {
                uint32_t k[8];
                fe_load(k, ks + (long long)(8 * cand) * B + base + row, B);
                comb_mul_one(acc, k, comb);
            } else {
                fe_set_small(acc.z, 1);
            }
            // jobs lie on the threads below p C (their level is below C)
            const int nw = warps_for(p * C < S2_THREADS ? p * C : S2_THREADS,
                                     S2_WARPS);
            block_inv<mod_p, S2_WARPS>(zi, acc.z, nw, sm.inv);
            if (job) sign_job_r(s, t, acc.x, zi);
            __syncthreads();
            int prow = 0;
            const uint32_t pend =
                t < p ? sign_decide<C>(s, t, p, prow) : 0u;
            compact(sm, pend, prow);
        }
        // thread t signs row t of the tile with its chosen candidate
        const bool live = t < n;
        const int i = base + t;
        uint32_t k[8], w[8], kinv[8], r2[8];
        fe_set_r2n(r2);
        if (live)
            fe_load(k, ks + (long long)(8 * s.sel[t]) * B + i, B);
        else
            fe_set_small(k, 1);
        block_inv<mod_n, S2_WARPS>(w, k, warps_for(n, S2_WARPS), sm.inv);
        fn_mont_mul(kinv, w, r2);                 // k^-1 R
        if (live) {
            uint32_t zw[8], dw[8], r[8], sv[8], ok;
            fe_load(zw, z + i, B);
            fe_load(dw, d + i, B);
#pragma unroll
            for (int j = 0; j < 8; j++) r[j] = s.r[j * S2_THREADS + t];
            sign_finish(zw, dw, r, kinv, sv, ok);
            fe_store(out_r + i, B, r);
            fe_store(out_s + i, B, sv);
            out_ok[i] = (uint8_t)ok;
            out_grind[i] = s.grind[t];
        }
        __syncthreads();          // the next tile rewrites the tile's state
    }
}

// The launch: at most the blocks the card holds at once (cached per
// device), each looping over tiles, and the rows spread over all of them
// (a small batch: a few rows a block, every candidate in the first round).
template <int C>
static int launch(const void *z, const void *d, const void *ks,
                  const void *comb, void *r, void *s, void *ok, void *grind,
                  int B, void *stream) {
    if (B <= 0) return 0;
    static int cache[64];
    const tiling g = spread(B, card_blocks((const void *)ecdsa_sign_kernel<C>,
                                           S2_THREADS, 0, cache),
                            S2_THREADS);
    if (g.grid == 0) return (int)cudaErrorInvalidConfiguration;
    ecdsa_sign_kernel<C><<<g.grid, S2_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)z, (const uint32_t *)d, (const uint32_t *)ks,
        (const uint32_t *)comb, (uint32_t *)r, (uint32_t *)s,
        (uint8_t *)ok, (uint8_t *)grind, B, g.rows);
    return (int)cudaGetLastError();
}

extern "C" int ecdsa_sign1_launch(const void *z, const void *d,
                                  const void *ks, const void *comb, void *r,
                                  void *s, void *ok, void *grind, int B,
                                  void *stream) {
    return launch<1>(z, d, ks, comb, r, s, ok, grind, B, stream);
}

extern "C" int ecdsa_sign4_launch(const void *z, const void *d,
                                  const void *ks, const void *comb, void *r,
                                  void *s, void *ok, void *grind, int B,
                                  void *stream) {
    return launch<4>(z, d, ks, comb, r, s, ok, grind, B, stream);
}

// Blocks of the C = 4 kernel resident on one SM at its launch
// configuration.
extern "C" int ecdsa_sign_blocks_per_sm(void) {
    return sm_blocks((const void *)ecdsa_sign_kernel<4>, S2_THREADS, 0);
}
