// S2, the ECDSA sign kernel, templated on the candidate count C: for each
// row, r and s of the signature of hash z by key d with the first of C
// nonce candidates whose r is low (bit 255 clear) and nonzero, else with
// candidate 0; s low-S normalized; ok (r and s nonzero) and grind (a
// low-R candidate was found) as bytes.  C = 4 is hsmd's grinding signer,
// C = 1 the bulk signer of the synthetic store.
//
// Replaces no pallas_call: in the JAX package these are XLA programs,
// lightning_tpu/crypto/secp256k1.py ecdsa_sign_kernel (:405, C =
// GRIND_CANDIDATES = 4) and ecdsa_sign_simple_kernel (:437, C = 1).  A
// hand kernel because the plain PyTorch version is a few thousand small
// launches a batch.  Bound: 32-bit integer multiply-adds: a comb k*G and a
// Fermat chain mod p per candidate tried (on random nonces 1 + 1/2 + 1/4
// + 1/8 = 1.875 of 4 on average), and one Montgomery chain mod n per row;
// 160 bytes a row of operands (C = 4) and the 60 KB table are small
// beside them.  Design: one thread per row (sign_one<C> in
// secp256k1.cuh), which stops at its first low-R candidate; z, d, the
// candidates (C, 8, B), r and s are planes with the batch fastest, so a
// warp's loads and stores are coalesced; the table is read through the
// read-only cache.
#include <cuda_runtime.h>
#include "secp256k1.cuh"

#define S2_THREADS 128

template <int C>
__global__ void __launch_bounds__(S2_THREADS)
ecdsa_sign_kernel(const uint32_t *__restrict__ z,
                  const uint32_t *__restrict__ d,
                  const uint32_t *__restrict__ ks,
                  const uint32_t *__restrict__ comb,
                  uint32_t *__restrict__ out_r, uint32_t *__restrict__ out_s,
                  uint8_t *__restrict__ out_ok,
                  uint8_t *__restrict__ out_grind, int B) {
    int i = blockIdx.x * S2_THREADS + threadIdx.x;
    if (i >= B) return;
    uint32_t zw[8], dw[8], r[8], s[8], ok, grind;
    fe_load(zw, z + i, B);
    fe_load(dw, d + i, B);
    sign_one<C>(zw, dw, ks + i, B, comb, r, s, ok, grind);
    fe_store(out_r + i, B, r);
    fe_store(out_s + i, B, s);
    out_ok[i] = (uint8_t)ok;
    out_grind[i] = (uint8_t)grind;
}

template <int C>
static int launch(const void *z, const void *d, const void *ks,
                  const void *comb, void *r, void *s, void *ok, void *grind,
                  int B, void *stream) {
    if (B <= 0) return 0;
    ecdsa_sign_kernel<C><<<(B + S2_THREADS - 1) / S2_THREADS, S2_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t *)z, (const uint32_t *)d, (const uint32_t *)ks,
        (const uint32_t *)comb, (uint32_t *)r, (uint32_t *)s,
        (uint8_t *)ok, (uint8_t *)grind, B);
    return (int)cudaGetLastError();
}

extern "C" int ecdsa_sign1_launch(const void *z, const void *d,
                                  const void *ks, const void *comb, void *r,
                                  void *s, void *ok, void *grind, int B,
                                  void *stream) {
    return launch<1>(z, d, ks, comb, r, s, ok, grind, B, stream);
}

extern "C" int ecdsa_sign4_launch(const void *z, const void *d,
                                  const void *ks, const void *comb, void *r,
                                  void *s, void *ok, void *grind, int B,
                                  void *stream) {
    return launch<4>(z, d, ks, comb, r, s, ok, grind, B, stream);
}

// Blocks of the C = 4 kernel resident on one SM at its launch
// configuration.
extern "C" int ecdsa_sign_blocks_per_sm(void) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, ecdsa_sign_kernel<4>, S2_THREADS, 0) != cudaSuccess)
        return -1;
    return n;
}
