// K6, the 64-window dual multiplication over pre-selected points:
// u1*G + u2*Q as acc = 16 acc + Q[w] + G[w], from infinity, where both
// points of every window were selected outside the kernel and stream in
// as (64, 3, 8, B) word planes.
//
// Replaces lightning_tpu/crypto/pallas_secp.py _dual_mul_kernel
// (pallas_call at :807).  Bound: 32-bit integer multiply-adds (64 x (4
// doublings + 2 additions) = 3,584 field multiplications per signature);
// the planes are 12 KB a signature, read once, about 0.8 GB a bucket of
// 65,536 (0.24 ms at 3.35 TB/s), far below the multiplies.  Design: one
// thread per signature, the accumulator in registers for all 64 windows
// (the TPU carried it across a sequential grid axis); the batch fastest
// in every plane, so a warp's loads are coalesced.  The body is
// dual_scan_one<dual_q_planes>, the one K5 runs over its key's table.
//
// Launch: K5's, DUAL_THREADS = 256 threads a block and 2 blocks an SM
// (128 registers a thread), so B = 65536 is one wave.  A window's two
// plane rows go by 48 4-byte cp.async copies into the thread's slot in
// shared memory before its four doublings, and are waited for just before
// its two additions: 48 words a thread, word k of thread t at
// k * DUAL_THREADS + t (no bank conflicts), 48 KB of dynamic shared memory
// a block, 96 KB an SM.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define DUAL_THREADS 256
#define DUAL_MIN_BLOCKS (512 / DUAL_THREADS)
#define DUAL_SMEM (DUAL_SLOT_WORDS * DUAL_THREADS * 4)

__global__ void __launch_bounds__(DUAL_THREADS, DUAL_MIN_BLOCKS)
dual_mul_planes_kernel(const uint32_t *__restrict__ qs,
                       const uint32_t *__restrict__ gs,
                       uint32_t *__restrict__ ox, uint32_t *__restrict__ oy,
                       uint32_t *__restrict__ oz, int B) {
    extern __shared__ __align__(16) uint32_t slots[];
    int i = blockIdx.x * DUAL_THREADS + threadIdx.x;
    if (i >= B) return;
    pt acc;
    const dual_q_planes q = {qs + i};
    dual_scan_one(q, gs + i, B, slots, threadIdx.x, DUAL_THREADS, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel.
static cudaError_t allow_smem() {
    return cudaFuncSetAttribute(dual_mul_planes_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                DUAL_SMEM);
}

extern "C" int dual_mul_planes_launch(const void *qs, const void *gs,
                                      void *x, void *y, void *z, int B,
                                      void *stream) {
    if (B <= 0) return 0;
    cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
    dual_mul_planes_kernel<<<(B + DUAL_THREADS - 1) / DUAL_THREADS,
                             DUAL_THREADS, DUAL_SMEM,
                             (cudaStream_t)stream>>>(
        (const uint32_t *)qs, (const uint32_t *)gs, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int dual_mul_planes_blocks_per_sm(void) {
    int n = 0;
    if (allow_smem() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, dual_mul_planes_kernel, DUAL_THREADS, DUAL_SMEM) !=
            cudaSuccess)
        return -1;
    return n;
}
