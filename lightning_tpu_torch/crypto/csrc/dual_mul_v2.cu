// K5, the 64-window dual multiplication without GLV, Q selected in the
// kernel: u1*G + u2*Q as acc = 16 acc + Qtab[d2] + G[w], from infinity.
// The per-key table v*Q (v = 0..15) comes in whole, signature-major as
// (B, 16, 3, 8) words, with the digit plane d2 (64, B); the G point of
// each window is selected outside the kernel, (64, 3, 8, B).
//
// Replaces lightning_tpu/crypto/pallas_secp.py _dual_mul_kernel_v2
// (pallas_call at :462).  Bound: 32-bit integer multiply-adds (64 x (4
// doublings + 2 additions) = 3,584 field multiplications per signature);
// the 7.9 KB of digits, table and planes each signature reads once are
// second.  Design: one thread per signature, the accumulator in
// registers for all 64 windows (the TPU carried it across a sequential
// grid axis); the thread reads the one table entry its digit names
// instead of the TPU's 16-way one-hot sum.  The body is
// dual_scan_one<dual_q_table>, the one K6 runs over its Q planes.
//
// Launch: DUAL_THREADS = 256 threads a block and __launch_bounds__ of
// DUAL_MIN_BLOCKS = 2 blocks an SM (128 registers a thread), so B = 65536
// (256 blocks) is one wave on 132 SMs.  A window's two points go into the
// thread's slot in shared memory before its four doublings and are
// waited for just before its two additions: the table entry, 96
// contiguous bytes at an address its digit names, by six 16-byte
// cp.async.cg copies (L2 only: no neighbour reads it), so a warp's fetch
// is 32 x 3 sectors whatever the digits; the G row by 24 4-byte copies of
// coalesced planes.  48 words a thread, 48 KB of dynamic shared memory a
// block, 96 KB an SM.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define DUAL_THREADS 256
#define DUAL_MIN_BLOCKS (512 / DUAL_THREADS)
#define DUAL_SMEM (DUAL_SLOT_WORDS * DUAL_THREADS * 4)

__global__ void __launch_bounds__(DUAL_THREADS, DUAL_MIN_BLOCKS)
dual_mul_v2_kernel(const int32_t *__restrict__ d2,
                   const uint32_t *__restrict__ qtab,
                   const uint32_t *__restrict__ gs, uint32_t *__restrict__ ox,
                   uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                   int B) {
    extern __shared__ __align__(16) uint32_t slots[];
    int i = blockIdx.x * DUAL_THREADS + threadIdx.x;
    if (i >= B) return;
    pt acc;
    const dual_q_table q = {d2 + i, qtab + (long long)i * DUAL_QTAB_WORDS};
    dual_scan_one(q, gs + i, B, slots, threadIdx.x, DUAL_THREADS, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel.
static cudaError_t allow_smem() {
    return cudaFuncSetAttribute(dual_mul_v2_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                DUAL_SMEM);
}

extern "C" int dual_mul_v2_launch(const void *d2, const void *qtab,
                                  const void *gs, void *x, void *y, void *z,
                                  int B, void *stream) {
    if (B <= 0) return 0;
    cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
    dual_mul_v2_kernel<<<(B + DUAL_THREADS - 1) / DUAL_THREADS, DUAL_THREADS,
                         DUAL_SMEM, (cudaStream_t)stream>>>(
        (const int32_t *)d2, (const uint32_t *)qtab, (const uint32_t *)gs,
        (uint32_t *)x, (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int dual_mul_v2_blocks_per_sm(void) {
    int n = 0;
    if (allow_smem() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dual_mul_v2_kernel, DUAL_THREADS, DUAL_SMEM) != cudaSuccess)
        return -1;
    return n;
}
