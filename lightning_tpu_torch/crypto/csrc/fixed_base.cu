// S1, the fixed-base kernel: for each scalar k, k*G as normalized affine
// (x, y) (infinity gives (0, 0)).  Public keys from secret keys.
//
// Replaces no pallas_call: in the JAX package this is an XLA program,
// lightning_tpu/crypto/secp256k1.py derive_pubkeys_kernel (:451, over
// fixed_base_mul :253 and point_to_affine :176).  It is a hand kernel
// because its plain PyTorch version is a few thousand small launches a
// batch.  Bound: 32-bit integer multiply-adds (about 60 mixed additions
// of 11 products mod p and one Fermat chain of 255 squarings and 15
// products a key); the 96 bytes a key reads and writes and the 60 KB
// table are small beside them.  Design: one thread per key, accumulator
// in registers (fixed_base_one in secp256k1.cuh); the table is read
// through the read-only cache, where the threads of a warp read the same
// row j in each window; k, x and y are (8, B) planes, batch fastest, so a
// warp's loads and stores are coalesced.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define S1_THREADS 128

__global__ void __launch_bounds__(S1_THREADS)
fixed_base_kernel(const uint32_t *__restrict__ k,
                  const uint32_t *__restrict__ comb,
                  uint32_t *__restrict__ ox, uint32_t *__restrict__ oy,
                  int B) {
    int i = blockIdx.x * S1_THREADS + threadIdx.x;
    if (i >= B) return;
    uint32_t kw[8], x[8], y[8];
    fe_load(kw, k + i, B);
    fixed_base_one(kw, comb, x, y);
    fe_store(ox + i, B, x);
    fe_store(oy + i, B, y);
}

extern "C" int fixed_base_launch(const void *k, const void *comb, void *x,
                                 void *y, int B, void *stream) {
    if (B <= 0) return 0;
    fixed_base_kernel<<<(B + S1_THREADS - 1) / S1_THREADS, S1_THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t *)k, (const uint32_t *)comb, (uint32_t *)x,
        (uint32_t *)y, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int fixed_base_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, fixed_base_kernel, S1_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}
