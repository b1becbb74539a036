// K5, the 64-window dual multiplication without GLV, Q selected in the
// kernel: u1*G + u2*Q as acc = 16 acc + Qtab[d2] + G[w], from infinity.
// The per-key table v*Q (v = 0..15) comes in whole as (16, 3, 8, B) word
// planes with the digit plane d2 (64, B); the G point of each window is
// selected outside the kernel, (64, 3, 8, B).
//
// Replaces lightning_tpu/crypto/pallas_secp.py _dual_mul_kernel_v2
// (pallas_call at :462).  Bound: 32-bit integer multiply-adds (64 x (4
// doublings + 2 additions) = 3,584 field multiplications per signature);
// the 7.9 KB of digits, table and planes each signature reads once are
// second.  Design: one thread per signature, the accumulator in
// registers for all 64 windows (the TPU carried it across a sequential
// grid axis); the thread reads the one table entry its digit names
// instead of the TPU's 16-way one-hot sum; the batch fastest in every
// operand, so a warp's loads are coalesced.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

__global__ void dual_mul_v2_kernel(const int32_t *__restrict__ d2,
                                   const uint32_t *__restrict__ qtab,
                                   const uint32_t *__restrict__ gs,
                                   uint32_t *__restrict__ ox,
                                   uint32_t *__restrict__ oy,
                                   uint32_t *__restrict__ oz, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    pt acc;
    dual_mul_v2_one(d2 + i, B, qtab + i, gs + i, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

extern "C" int dual_mul_v2_launch(const void *d2, const void *qtab,
                                  const void *gs, void *x, void *y, void *z,
                                  int B, void *stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    dual_mul_v2_kernel<<<(B + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t *)d2, (const uint32_t *)qtab, (const uint32_t *)gs,
        (uint32_t *)x, (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}
