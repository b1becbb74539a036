// K4, the GLV window scan with separate fixed-base additions: u1*G + u2*Q
// as 33 windows of acc = 16 acc + Qlo[d2l] + Qhi[d2h] + G1[w] + G2[w],
// from infinity.  The per-key tables come from K2 (or from the plain
// table build of the pallas_glv engine) in K2's (6, 16, 8, B) layout; G1
// and G2 are the signed G and phi(G) points of each window, selected
// outside the kernel as (33, 3, 8, B) word planes.
//
// Replaces lightning_tpu/crypto/pallas_secp.py _make_glv_kernel(2) (the
// n_g = 2 scan, pallas_call at :627 via _run_glv_scan :608).  Bound:
// 32-bit integer multiply-adds (33 x (4 doublings + 4 additions) = 2,640
// field multiplications per signature); the 6.3 KB of planes and the
// 3 KB of tables each signature reads once are second.  Design: K3's,
// with two streamed plane loads in place of the joint-table gather: one
// thread per signature, the accumulator in registers for all 33 windows,
// the table entry read directly (verification inputs are public), the
// batch fastest in every operand so a warp's loads are coalesced.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

__global__ void glv_scan2_kernel(const int32_t *__restrict__ d2l,
                                 const int32_t *__restrict__ d2h,
                                 const uint32_t *__restrict__ tab,
                                 const uint32_t *__restrict__ g1,
                                 const uint32_t *__restrict__ g2,
                                 uint32_t *__restrict__ ox,
                                 uint32_t *__restrict__ oy,
                                 uint32_t *__restrict__ oz, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    pt acc;
    glv_scan2_one(d2l + i, d2h + i, B, tab + i, g1 + i, g2 + i, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

extern "C" int glv_scan2_launch(const void *d2l, const void *d2h,
                                const void *tab, const void *g1,
                                const void *g2, void *x, void *y, void *z,
                                int B, void *stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    glv_scan2_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t *)d2l, (const int32_t *)d2h, (const uint32_t *)tab,
        (const uint32_t *)g1, (const uint32_t *)g2, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}
