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
// 3 KB of tables each signature reads once are second.  Design: K3's, by
// construction: the body is glv_scan_one<2>, the one K3 runs at n_g = 1,
// as the TPU's _make_glv_kernel(n_g) is one body for both arities.  One
// thread per signature, the accumulator in registers for all 33 windows,
// the table entries read directly (verification inputs are public), the
// batch fastest in every operand so a warp's loads are coalesced.
//
// Launch: K3's, GLV_THREADS = 256 threads a block and 2 blocks an SM
// (128 registers a thread), so B = 65536 is one wave.  A window's four
// points (two table entries at digit-dependent addresses, two plane rows)
// go by 96 4-byte cp.async copies into the thread's slot in shared memory
// before its four doublings, and are waited for just before its four
// additions: 96 words a thread, word k of thread t at k * GLV_THREADS + t
// (no bank conflicts), 96 KB of dynamic shared memory a block, 192 KB an
// SM.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define GLV_THREADS 256
#define GLV_MIN_BLOCKS (512 / GLV_THREADS)
#define GLV_SMEM (GLV_SLOT_WORDS(2) * GLV_THREADS * 4)

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
glv_scan2_kernel(const int32_t *__restrict__ d2l,
                 const int32_t *__restrict__ d2h,
                 const uint32_t *__restrict__ tab,
                 const uint32_t *__restrict__ g1,
                 const uint32_t *__restrict__ g2, uint32_t *__restrict__ ox,
                 uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                 int B) {
    extern __shared__ uint32_t slots[];
    int i = blockIdx.x * GLV_THREADS + threadIdx.x;
    if (i >= B) return;
    pt acc;
    const glv_fixed<2> fx = {g1 + i, g2 + i};
    glv_scan_one<2>(d2l + i, d2h + i, B, tab + i, fx, slots + threadIdx.x,
                    GLV_THREADS, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel.
static cudaError_t allow_smem() {
    return cudaFuncSetAttribute(glv_scan2_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                GLV_SMEM);
}

extern "C" int glv_scan2_launch(const void *d2l, const void *d2h,
                                const void *tab, const void *g1,
                                const void *g2, void *x, void *y, void *z,
                                int B, void *stream) {
    if (B <= 0) return 0;
    cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
    glv_scan2_kernel<<<(B + GLV_THREADS - 1) / GLV_THREADS, GLV_THREADS,
                       GLV_SMEM, (cudaStream_t)stream>>>(
        (const int32_t *)d2l, (const int32_t *)d2h, (const uint32_t *)tab,
        (const uint32_t *)g1, (const uint32_t *)g2, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int glv_scan2_blocks_per_sm(void) {
    int n = 0;
    if (allow_smem() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, glv_scan2_kernel, GLV_THREADS, GLV_SMEM) != cudaSuccess)
        return -1;
    return n;
}
