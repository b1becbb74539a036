// K3, the GLV window scan: u1*G + u2*Q as 33 windows of
// acc = 16 acc + Qlo[d2l] + Qhi[d2h] + Gjoint[g], from infinity, with the
// per-key tables from K2 and the 1024-entry joint G / phi(G) table.
//
// Replaces lightning_tpu/crypto/pallas_secp.py _make_glv_kernel(1) (the
// n_g = 1 scan, pallas_call at :627).  Bound: 32-bit integer multiply-adds
// (33 x (4 doublings + 3 additions) = 2,244 field multiplications per
// signature); the tables are read once.  Design: one thread per
// signature with the accumulator in registers for all 33 windows (the TPU
// carried it across a sequential grid axis; a CUDA grid has no order).
// Selection reads the chosen table entry directly, since verification
// inputs are public.  The body is glv_scan_one<1>, which K4 shares at
// n_g = 2, as the TPU kernels share _make_glv_kernel.
//
// Launch: GLV_THREADS = 256 threads a block and __launch_bounds__ of
// GLV_MIN_BLOCKS = 2 blocks an SM, which caps a thread at 128 registers:
// 264 blocks run at once on 132 SMs, so B = 65536 (256 blocks) is one
// wave.  (128 threads and 4 blocks an SM, and 64 and 8, ran 3-4 % slower
// on the H100: kernel_ablation.py.)  The three entries a window adds sit
// at addresses that depend on the thread's digits, not on the
// accumulator: each window starts their 72 4-byte cp.async copies into
// the thread's slot in shared memory before its four doublings and waits
// for them just before its three additions.  The slot is 72 words a
// thread, word k of thread t at k * GLV_THREADS + t, so a warp's reads
// fall on 32 banks: 72 KB of dynamic shared memory a block, 144 KB an SM.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define GLV_THREADS 256
#define GLV_MIN_BLOCKS (512 / GLV_THREADS)
#define GLV_SMEM (GLV_SLOT_WORDS(1) * GLV_THREADS * 4)

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
glv_scan_kernel(const int32_t *__restrict__ d2l,
                const int32_t *__restrict__ d2h,
                const int32_t *__restrict__ gidx,
                const uint32_t *__restrict__ tab,
                const uint32_t *__restrict__ jt, uint32_t *__restrict__ ox,
                uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                int B) {
    extern __shared__ uint32_t slots[];
    int i = blockIdx.x * GLV_THREADS + threadIdx.x;
    if (i >= B) return;
    pt acc;
    const glv_fixed<1> fx = {gidx + i, jt};
    glv_scan_one<1>(d2l + i, d2h + i, B, tab + i, fx, slots + threadIdx.x,
                    GLV_THREADS, acc);
    fe_store(ox + i, B, acc.x);
    fe_store(oy + i, B, acc.y);
    fe_store(oz + i, B, acc.z);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel.
static cudaError_t allow_smem() {
    return cudaFuncSetAttribute(glv_scan_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                GLV_SMEM);
}

extern "C" int glv_scan_launch(const void *d2l, const void *d2h,
                               const void *gidx, const void *tab,
                               const void *jt, void *x, void *y, void *z,
                               int B, void *stream) {
    if (B <= 0) return 0;
    cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
    glv_scan_kernel<<<(B + GLV_THREADS - 1) / GLV_THREADS, GLV_THREADS,
                      GLV_SMEM, (cudaStream_t)stream>>>(
        (const int32_t *)d2l, (const int32_t *)d2h, (const int32_t *)gidx,
        (const uint32_t *)tab, (const uint32_t *)jt, (uint32_t *)x,
        (uint32_t *)y, (uint32_t *)z, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int glv_scan_blocks_per_sm(void) {
    int n = 0;
    if (allow_smem() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, glv_scan_kernel, GLV_THREADS, GLV_SMEM) != cudaSuccess)
        return -1;
    return n;
}
