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
// in every plane, so a warp's loads are coalesced.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

__global__ void dual_mul_planes_kernel(const uint32_t *__restrict__ qs,
                                       const uint32_t *__restrict__ gs,
                                       uint32_t *__restrict__ ox,
                                       uint32_t *__restrict__ oy,
                                       uint32_t *__restrict__ oz, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    pt acc;
    dual_mul_planes_one(qs + i, gs + i, B, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

extern "C" int dual_mul_planes_launch(const void *qs, const void *gs,
                                      void *x, void *y, void *z, int B,
                                      void *stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    dual_mul_planes_kernel<<<(B + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t *)qs, (const uint32_t *)gs, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}
