// K1, the verify prep kernel: for each signature, y = sqrt(x^3 + 7) mod p,
// the on-curve residue d = y^2 - (x^3 + 7) mod p, and w = s^-1 mod n
// (0 for s = 0 mod n).
//
// Replaces lightning_tpu/crypto/pallas_secp.py _verify_prep_kernel
// (pallas_call at :322).  Bound: 32-bit integer multiply-adds; the 96
// bytes each thread reads and writes are nothing beside them.
//
// How it inverts: one Fermat chain per block, not per thread
// (Montgomery's trick, fn_inv_batch in secp256k1.cuh, in the Montgomery
// domain mod n).  A block is PREP_THREADS signature threads and one more
// warp for the chain:
//   1. each signature thread enters its s mod n (0 counts as 1);
//   2. each signature warp scans its 32 values into inclusive prefix and
//      suffix products (5 shuffle steps each), and each thread keeps x,
//      the product of the other 31 values of its warp;
//   3. lane 0 of the chain warp inverts the PREP_WARPS warp products with
//      one chain (fn_inv_sweep) while the signature warps take their
//      square roots, so the block waits for the longer of the two and not
//      for both;
//   4. w = x * (its warp's product)^-1.
// A signature pays 13 Montgomery products and 1/PREP_THREADS of one chain
// (255 squarings, 81 multiplications) and of the sweep's 3 PREP_WARPS + 1
// products around it, where a chain per thread cost 336.  The chain warp
// issues as a whole warp for its one lane: its 38,556 products cost as
// much issue as about 2.7 signature warps (about 14,400 a thread), so the
// block is 256 signatures (8 warps) to keep that share small, 2 blocks an
// SM.  On the H100 (kernel_ablation.py) 128 signatures a block ran 15 %
// slower and 512 no faster; at 128, the chain on signature warp 0 (which
// then took its own square roots after it) ran 5 % slower than on a warp
// of its own.  Threads past B take part with s = 1 and store nothing,
// since the block synchronizes.  Planes are limbs first (8, B), so the
// threads of a warp read neighbouring words.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define PREP_THREADS 256
#define PREP_WARPS (PREP_THREADS / 32)

__global__ void __launch_bounds__(PREP_THREADS + 32)
verify_prep_kernel(const uint32_t *__restrict__ qx,
                   const uint32_t *__restrict__ s,
                   uint32_t *__restrict__ oy, uint32_t *__restrict__ od,
                   uint32_t *__restrict__ ow, int B) {
    __shared__ uint32_t warp_prod[PREP_WARPS * 8];   // Montgomery domain
    __shared__ uint32_t warp_inv[PREP_WARPS * 8];    // plain
    __shared__ uint32_t scratch[PREP_WARPS * 8];
    const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
    const bool chain_warp = wid == PREP_WARPS;
    const int i = blockIdx.x * PREP_THREADS + t;
    const bool live = !chain_warp && i < B;

    uint32_t x[8], zero = 0;
    if (!chain_warp) {
        uint32_t sv[8], a[8];
        if (live) fe_load(sv, s + i, B); else fe_set_small(sv, 1);
        zero = fn_batch_enter(a, sv);
        warp_scan_others<mod_n>(x, a, warp_prod + 8 * wid);
    }
    __syncthreads();

    if (chain_warp) {
        if (lane == 0) fn_inv_sweep(warp_inv, warp_prod, scratch, PREP_WARPS);
    } else if (live) {
        uint32_t q[8], y[8], d[8];
        fe_load(q, qx + i, B);
        verify_prep_sqrt_one(q, y, d);
        fe_store(oy + i, B, y);
        fe_store(od + i, B, d);
    }
    __syncthreads();
    if (live) {
        uint32_t w[8];
        fn_batch_out(w, x, warp_inv + 8 * wid, zero);
        fe_store(ow + i, B, w);
    }
}

extern "C" int verify_prep_launch(const void *qx, const void *s, void *y,
                                  void *d, void *w, int B, void *stream) {
    if (B <= 0) return 0;
    verify_prep_kernel<<<(B + PREP_THREADS - 1) / PREP_THREADS,
                         PREP_THREADS + 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)qx, (const uint32_t *)s, (uint32_t *)y,
        (uint32_t *)d, (uint32_t *)w, B);
    return (int)cudaGetLastError();
}
