// K2, the table build kernel: for each key, the lo table
// lo[v] = v * (x, +-y) for v = 0..15 (14 complete additions, entry 0 the
// point at infinity) and the hi table hi[v] = (beta * X_v, +-Y_v, Z_v),
// the endomorphism of +-lo[v].
//
// Replaces lightning_tpu/crypto/pallas_secp.py _build_tables_kernel
// (pallas_call at :735).  Bound: 32-bit integer multiply-adds (14 point
// additions and 15 beta multiplications, 169 field multiplications and
// 28 small multiples per key); the 3 KB of table each key writes is
// second.  Design: one thread per key; output (6, 16, 8, B) with the
// batch fastest, so a warp's stores are coalesced and the scan kernels
// read them the same way.  The base's Z is 1, so each addition is
// pt_add_z1, which takes no product by it (the TPU kernel multiplies by
// the constant; the residues are the same).
//
// Launch: K2_THREADS = 64 threads a block and no launch bounds.  ptxas
// gives a thread 174 registers and spills none, so an SM holds 8 warps
// (4 blocks), and B = 65536 runs in 1.94 waves.  More warps did not help
// on the H100 (kernel_ablation.py), as if 8 warps an SM already issued
// all the SM can: 16 warps (128 registers: 256 threads and 2 blocks an
// SM, or 128 and 4, 100 bytes spilled; or the base and beta kept in
// shared memory, 4-16 bytes spilled) ran no faster, and 12 warps (1.29
// waves) 30-38 % slower.  64, 128 and 32 threads a block (8 warps each)
// came within 4 % of each other, 64 with the lowest mean.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define K2_THREADS 64

__global__ void
build_tables_kernel(const uint32_t *__restrict__ bx,
                    const uint32_t *__restrict__ byl,
                    const int32_t *__restrict__ sflip,
                    uint32_t *__restrict__ out, int B) {
    int i = blockIdx.x * K2_THREADS + threadIdx.x;
    if (i >= B) return;
    uint32_t x[8], y[8];
    fe_load(x, bx + i, B);
    fe_load(y, byl + i, B);
    build_tables_one(x, y, (uint32_t)sflip[i], out + i, B);
}

extern "C" int build_tables_launch(const void *bx, const void *byl,
                                   const void *sflip, void *out, int B,
                                   void *stream) {
    if (B <= 0) return 0;
    build_tables_kernel<<<(B + K2_THREADS - 1) / K2_THREADS, K2_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t *)bx, (const uint32_t *)byl, (const int32_t *)sflip,
        (uint32_t *)out, B);
    return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at its launch configuration.
extern "C" int build_tables_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, build_tables_kernel, K2_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}
