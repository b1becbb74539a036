// S1, the fixed-base kernel: for each scalar k, k*G as normalized affine
// (x, y) (infinity gives (0, 0)).  Public keys from secret keys.
//
// Replaces no pallas_call: in the JAX package this is an XLA program,
// lightning_tpu/crypto/secp256k1.py derive_pubkeys_kernel (:451, over
// fixed_base_mul :253 and point_to_affine :176).  It is a hand kernel
// because its plain PyTorch version is a few thousand small launches a
// batch.  Bound: 32-bit integer multiply-adds (about 60 mixed additions
// of 11 products mod p a key, the batch inversion's products and
// 1/S1_THREADS of its Fermat chain); the 96 bytes a key reads and writes
// and the 60 KB table are small beside them.
//
// Design: one thread per key, the comb's accumulator in registers
// (comb_mul_one in secp256k1.cuh); 1/Z by one batch inversion mod p over
// the block (Montgomery's trick, block_inv: warp scans, one Fermat chain
// on thread 0), as the JAX package's point_to_affine inverts a batch.  The
// grid is sized from the occupancy query: at most the blocks the card
// holds at once, each looping over tiles of keys, the keys a tile spread
// over all of them (a small batch: a few keys a block).  The comb table
// (61,440 bytes) is copied into the block's shared memory by one bulk
// asynchronous copy when the block starts; the threads of a warp read the
// same row j in each window.  k, x and y are (8, B) planes, batch
// fastest, so a warp's loads and stores are coalesced.
//
// One block an SM (__launch_bounds__ with 1: at most 128 registers a
// thread).  kernel_ablation.py timed each step of this design against the
// one before it (PERF.md).
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define S1_THREADS 512       // threads a block, keys a tile at most
#define S1_WARPS (S1_THREADS / 32)
#define S1_SMEM_BYTES COMB_TABLE_BYTES   // dynamic shared memory: the table

__global__ void __launch_bounds__(S1_THREADS, 1)
fixed_base_kernel(const uint32_t *__restrict__ k,
                  const uint32_t *__restrict__ comb,
                  uint32_t *__restrict__ ox, uint32_t *__restrict__ oy,
                  int B, int keys) {
    __shared__ block_inv_smem<S1_WARPS> sm;
    extern __shared__ __align__(16) uint32_t table[];
    __shared__ uint64_t table_bar;
    comb_table_to_shared(table, comb, &table_bar);
    const int tiles = (B + keys - 1) / keys;
#pragma unroll 1
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int i = tile * keys + threadIdx.x;
        const bool live = threadIdx.x < keys && i < B;
        pt acc;
        uint32_t zi[8];
        if (live) {
            uint32_t kw[8];
            fe_load(kw, k + i, B);
            comb_mul_one<false>(acc, kw, table);
        } else {
            fe_set_small(acc.z, 1);
        }
        const int n = B - tile * keys < keys ? B - tile * keys : keys;
        block_inv<mod_p, S1_WARPS>(zi, acc.z, warps_for(n, S1_WARPS), sm);
        if (live) {
            uint32_t x[8], y[8];
            fp_mul(x, acc.x, zi);
            fp_mul(y, acc.y, zi);
            fe_store(ox + i, B, x);
            fe_store(oy + i, B, y);
        }
    }
}

extern "C" int fixed_base_launch(const void *k, const void *comb, void *x,
                                 void *y, int B, void *stream) {
    if (B <= 0) return 0;
    static int cache[64];
    const tiling g = spread(B, card_blocks((const void *)fixed_base_kernel,
                                           S1_THREADS, S1_SMEM_BYTES, cache),
                            S1_THREADS);
    if (g.grid == 0) return (int)cudaErrorInvalidConfiguration;
    fixed_base_kernel<<<g.grid, S1_THREADS, S1_SMEM_BYTES,
                        (cudaStream_t)stream>>>(
        (const uint32_t *)k, (const uint32_t *)comb, (uint32_t *)x,
        (uint32_t *)y, B, g.rows);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int fixed_base_blocks_per_sm(void) {
    return sm_blocks((const void *)fixed_base_kernel, S1_THREADS,
                     S1_SMEM_BYTES);
}
