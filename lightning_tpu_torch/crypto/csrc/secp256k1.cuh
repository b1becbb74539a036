// secp256k1 field, scalar and point arithmetic for the verify and sign
// kernels.
//
// Representation: a field element is 8 little-endian 32-bit words, fully
// reduced ([0, p) or [0, n)) after every operation.  One thread owns one
// signature, so every value below lives in that thread's registers, but
// for the steps a block takes together: the batch inversions (block_inv)
// and S2's candidate rounds (sign_tile), whose state is in shared memory.
//
// * products: the 8x8-word product (64 32-bit products) and the squaring
//   (36: 8 squares and 28 doubled cross products) into 16 words.  On the
//   device pass they are PTX carry chains (mad.lo.cc / madc.hi.cc); the
//   product runs the even and the odd words of a row as two independent
//   chains.  The host pass compiles a portable C body with 64-bit
//   accumulators; it is what tests/test_torch_csrc_host.py checks, the PTX
//   is checked on the card.
// * mod p: the pseudo-Mersenne fold 2^256 = 2^32 + 977 (mod p), PTX on the
//   device; a second fold of the 33 bits left; then one branchless
//   conditional subtraction.  Add, sub and every conditional subtraction
//   compute both candidates from the carry or borrow flag and select with
//   a mask: no data-dependent branch.
// * mod n: Montgomery multiplication and squaring (R = 2^256) as a product
//   and a separate reduction (REDC); used by the prep kernel's inversions
//   and the sign kernel's s = k^-1 (z + r d), which run in the Montgomery
//   domain.
// * k*G: a comb over a table of v * 2^(4j) * G (64 windows, one mixed
//   addition each, no doubling), then x / Z by a block's batch inversion
//   mod p (Montgomery's trick: one Fermat chain a block).
// * points: homogeneous projective (X:Y:Z), infinity (0:1:0), with the
//   Renes-Costello-Batina complete formulas for a = 0 (b3 = 21), in the
//   same operation order as the plain PyTorch engine, so every output is
//   the same residue.
//
// Every function is __host__ __device__ so that the arithmetic can also be
// compiled by a host C++ compiler and checked against the exact-int
// oracle without a card; only the warp and block steps (warp shuffles,
// barriers, the occupancy query) are CUDA's alone.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

#define SECP_B3 21u

// ---------------------------------------------------------------------------
// Constants (little-endian words)

HD void fe_set_p(uint32_t r[8]) {
    r[0] = 0xFFFFFC2Fu; r[1] = 0xFFFFFFFEu;
    for (int i = 2; i < 8; i++) r[i] = 0xFFFFFFFFu;
}

// 2^256 - p = 2^32 + 977: adding it subtracts p modulo 2^256.
HD void fe_set_pc(uint32_t r[8]) {
    r[0] = 0x3D1u; r[1] = 1u;
    for (int i = 2; i < 8; i++) r[i] = 0;
}

HD void fe_set_n(uint32_t r[8]) {
    r[0] = 0xD0364141u; r[1] = 0xBFD25E8Cu; r[2] = 0xAF48A03Bu;
    r[3] = 0xBAAEDCE6u; r[4] = 0xFFFFFFFEu;
    r[5] = 0xFFFFFFFFu; r[6] = 0xFFFFFFFFu; r[7] = 0xFFFFFFFFu;
}

HD void fe_set_beta(uint32_t r[8]) {
    r[0] = 0x719501EEu; r[1] = 0xC1396C28u; r[2] = 0x12F58995u;
    r[3] = 0x9CF04975u; r[4] = 0xAC3434E9u; r[5] = 0x6E64479Eu;
    r[6] = 0x657C0710u; r[7] = 0x7AE96A2Bu;
}

// 2^512 mod n: multiplying by it enters the Montgomery domain.
HD void fe_set_r2n(uint32_t r[8]) {
    r[0] = 0x67D7D140u; r[1] = 0x896CF214u; r[2] = 0x0E7CF878u;
    r[3] = 0x741496C2u; r[4] = 0x5BCD07C6u; r[5] = 0xE697F5E4u;
    r[6] = 0x81C69BC5u; r[7] = 0x9D671CD5u;
}

// 2^256 mod n: 1 in the Montgomery domain.
HD void fe_set_rn(uint32_t r[8]) {
    r[0] = 0x2FC9BEBFu; r[1] = 0x402DA173u; r[2] = 0x50B75FC4u;
    r[3] = 0x45512319u; r[4] = 1u;
    r[5] = 0; r[6] = 0; r[7] = 0;
}

#define SECP_N0INV 0x5588B13Fu  // -n^-1 mod 2^32

HD void fe_set_small(uint32_t r[8], uint32_t v) {
    r[0] = v;
    for (int i = 1; i < 8; i++) r[i] = 0;
}

HD void fe_copy(uint32_t r[8], const uint32_t a[8]) {
    for (int i = 0; i < 8; i++) r[i] = a[i];
}

HD uint32_t fe_is_zero(const uint32_t a[8]) {
    uint32_t acc = 0;
    for (int i = 0; i < 8; i++) acc |= a[i];
    return acc == 0;
}

// r = a where mask is all ones, b where it is 0
HD void fe_select(uint32_t r[8], uint32_t mask, const uint32_t a[8],
                  const uint32_t b[8]) {
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = (a[i] & mask) | (b[i] & ~mask);
}

// ---------------------------------------------------------------------------
// PTX carry chains (device pass only)

#ifdef __CUDA_ARCH__
#define PTX_OP3(name, op)                                                   \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {      \
        uint32_t r;                                                         \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));         \
        return r;                                                           \
    }
#define PTX_OP4(name, op)                                                   \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,        \
                                             uint32_t c) {                  \
        uint32_t r;                                                         \
        asm volatile(op " %0, %1, %2, %3;"                                  \
                     : "=r"(r) : "r"(a), "r"(b), "r"(c));                   \
        return r;                                                           \
    }
PTX_OP3(add_cc, "add.cc.u32")
PTX_OP3(addc_cc, "addc.cc.u32")
PTX_OP3(addc, "addc.u32")
PTX_OP3(sub_cc, "sub.cc.u32")
PTX_OP3(subc_cc, "subc.cc.u32")
PTX_OP3(subc, "subc.u32")
PTX_OP4(mad_lo_cc, "mad.lo.cc.u32")
PTX_OP4(madc_lo_cc, "madc.lo.cc.u32")
PTX_OP4(mad_hi_cc, "mad.hi.cc.u32")
PTX_OP4(madc_hi_cc, "madc.hi.cc.u32")
PTX_OP4(madc_hi, "madc.hi.u32")
PTX_OP4(mad_hi, "mad.hi.u32")
#undef PTX_OP3
#undef PTX_OP4
#endif

// ---------------------------------------------------------------------------
// Word-level chains

// r = a + b, returns the carry out
HD uint32_t fe_add_raw(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
#ifdef __CUDA_ARCH__
    r[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = addc_cc(a[i], b[i]);
    return addc(0, 0);
#else
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a[i] + b[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    return (uint32_t)c;
#endif
}

// r = a - b, returns 1 on borrow
HD uint32_t fe_sub_raw(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
#ifdef __CUDA_ARCH__
    r[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r[i] = subc_cc(a[i], b[i]);
    return subc(0, 0) & 1u;
#else
    uint64_t bw = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t d = (uint64_t)a[i] - b[i] - bw;
        r[i] = (uint32_t)d;
        bw = (d >> 32) & 1;
    }
    return (uint32_t)bw;
#endif
}

// t = a * b, 16 words.  Device: row i adds a[j] * b[i] for even j into
// e[i..i+8] and for odd j into o[i+1..i+8], two carry chains with no
// dependence on each other; t = e + o at the end.
HD void fe_mul_wide(uint32_t t[16], const uint32_t a[8], const uint32_t b[8]) {
#ifdef __CUDA_ARCH__
    uint32_t e[16], o[16];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        e[j] = a[j] * b[0];
        e[j + 1] = __umulhi(a[j], b[0]);
        o[j + 1] = a[j + 1] * b[0];
        o[j + 2] = __umulhi(a[j + 1], b[0]);
    }
    e[8] = 0;
#pragma unroll
    for (int i = 1; i < 8; i++) {
        e[i] = mad_lo_cc(a[0], b[i], e[i]);
        e[i + 1] = madc_hi_cc(a[0], b[i], e[i + 1]);
#pragma unroll
        for (int j = 2; j < 8; j += 2) {
            e[i + j] = madc_lo_cc(a[j], b[i], e[i + j]);
            e[i + j + 1] = madc_hi_cc(a[j], b[i], e[i + j + 1]);
        }
        e[i + 8] = addc(0, 0);
        o[i + 1] = mad_lo_cc(a[1], b[i], o[i + 1]);
        o[i + 2] = madc_hi_cc(a[1], b[i], o[i + 2]);
#pragma unroll
        for (int j = 3; j < 7; j += 2) {
            o[i + j] = madc_lo_cc(a[j], b[i], o[i + j]);
            o[i + j + 1] = madc_hi_cc(a[j], b[i], o[i + j + 1]);
        }
        o[i + 7] = madc_lo_cc(a[7], b[i], o[i + 7]);
        o[i + 8] = madc_hi(a[7], b[i], 0);   // the top word: no carry out
    }
    t[0] = e[0];
    t[1] = add_cc(e[1], o[1]);
#pragma unroll
    for (int k = 2; k < 15; k++) t[k] = addc_cc(e[k], o[k]);
    t[15] = addc(e[15], o[15]);
#else
    for (int i = 0; i < 16; i++) t[i] = 0;
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)a[j] * b[i] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
#endif
}

// t = a^2, 16 words: the 28 cross products a[i] a[j] (i < j), doubled,
// plus the 8 squares on the diagonal.
HD void fe_sqr_wide(uint32_t t[16], const uint32_t a[8]) {
#pragma unroll
    for (int k = 0; k < 16; k++) t[k] = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < 7; i++) {
        // low halves into t[2i+1 .. i+7], the carry into the fresh t[i+8]
        t[2 * i + 1] = mad_lo_cc(a[i], a[i + 1], t[2 * i + 1]);
#pragma unroll
        for (int j = i + 2; j < 8; j++)
            t[i + j] = madc_lo_cc(a[i], a[j], t[i + j]);
        t[i + 8] = addc(0, 0);
        // high halves into t[2i+2 .. i+8]; the row's sum fits: no carry out
        if (i == 6) {
            t[14] = mad_hi(a[6], a[7], t[14]);
        } else {
            t[2 * i + 2] = mad_hi_cc(a[i], a[i + 1], t[2 * i + 2]);
#pragma unroll
            for (int j = i + 2; j < 7; j++)
                t[i + j + 1] = madc_hi_cc(a[i], a[j], t[i + j + 1]);
            t[i + 8] = madc_hi(a[i], a[7], t[i + 8]);
        }
    }
#else
    for (int i = 0; i < 7; i++) {
        uint64_t c = 0;
        for (int j = i + 1; j < 8; j++) {
            c += (uint64_t)a[i] * a[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
#endif
    // double the cross products (their sum is below 2^511)
    t[15] = t[14] >> 31;
#pragma unroll
    for (int k = 14; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
#ifdef __CUDA_ARCH__
    t[0] = mad_lo_cc(a[0], a[0], t[0]);
    t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
    for (int i = 1; i < 7; i++) {
        t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
        t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
    }
    t[14] = madc_lo_cc(a[7], a[7], t[14]);
    t[15] = madc_hi(a[7], a[7], t[15]);
#else
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a[i] * a[i] + t[2 * i];
        t[2 * i] = (uint32_t)c;
        c = (c >> 32) + t[2 * i + 1];
        t[2 * i + 1] = (uint32_t)c;
        c >>= 32;
    }
#endif
}

// r = a mod m for any 256-bit a (a < 2^256 < 2m)
HD void fe_reduce_once(uint32_t r[8], const uint32_t a[8], const uint32_t m[8]) {
    uint32_t t[8];
    uint32_t bw = fe_sub_raw(t, a, m);
    fe_select(r, 0u - bw, a, t);
}

// ---------------------------------------------------------------------------
// Arithmetic mod p

// r = (carry * 2^256 + r) mod p for a value below 2^256 + 2^67 (carry set)
// or below 2^256 (carry 0): r + 2^32 + 977 modulo 2^256 is the value less
// p; take it where the carry or the addition overflows.
HD void fp_final(uint32_t r[8], uint32_t carry) {
    uint32_t pc[8], t[8];
    fe_set_pc(pc);
    uint32_t c = fe_add_raw(t, r, pc);
    fe_select(r, 0u - (carry | c), t, r);
}

// r = (s + (hi * 2^32 + lo) * 2^256) mod p for hi <= 1, by 2^256 = 2^32 +
// 977: the fold adds at most 2^66.
HD void fp_fold_top(uint32_t r[8], const uint32_t s[8], uint32_t lo,
                    uint32_t hi) {
    uint64_t m = (uint64_t)lo * 977u;
    uint64_t c = (uint64_t)s[0] + (uint32_t)m;
    r[0] = (uint32_t)c;
    c = (c >> 32) + s[1] + (m >> 32) + lo + (uint64_t)hi * 977u;
    r[1] = (uint32_t)c;
    c = (c >> 32) + s[2] + hi;
    r[2] = (uint32_t)c;
#pragma unroll
    for (int i = 3; i < 8; i++) {
        c = (c >> 32) + s[i];
        r[i] = (uint32_t)c;
    }
    fp_final(r, (uint32_t)(c >> 32));
}

// r = t mod p for a 16-word t = L + H * 2^256: s = L + 977 H + (H << 32)
// in 9 words and a carry, then the fold of those 33 bits.
HD void fp_reduce_wide(uint32_t r[8], const uint32_t t[16]) {
    const uint32_t *L = t, *H = t + 8;
    uint32_t s[8], s8, s9;
#ifdef __CUDA_ARCH__
    s[0] = mad_lo_cc(H[0], 977u, L[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) s[i] = madc_lo_cc(H[i], 977u, L[i]);
    s8 = addc(0, 0);
    s[1] = mad_hi_cc(H[0], 977u, s[1]);
#pragma unroll
    for (int i = 2; i < 8; i++) s[i] = madc_hi_cc(H[i - 1], 977u, s[i]);
    s8 = madc_hi(H[7], 977u, s8);
    s[1] = add_cc(s[1], H[0]);
#pragma unroll
    for (int i = 2; i < 8; i++) s[i] = addc_cc(s[i], H[i - 1]);
    s8 = addc_cc(s8, H[7]);
    s9 = addc(0, 0);
#else
    uint64_t c = 0;
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)H[i] * 977u + L[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    uint64_t top = c;                         // < 2^10
    c = 0;
    for (int i = 1; i < 8; i++) {
        c += (uint64_t)s[i] + H[i - 1];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    top += c + H[7];                          // < 2^33
    s8 = (uint32_t)top;
    s9 = (uint32_t)(top >> 32);
#endif
    fp_fold_top(r, s, s8, s9);
}

HD void fp_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t c = fe_add_raw(r, a, b);
    fp_final(r, c);
}

// a - b, plus p where it borrows: subtracting 2^32 + 977 adds p mod 2^256
HD void fp_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t mask = 0u - fe_sub_raw(r, a, b);
    uint32_t pc[8];
    fe_set_pc(pc);
    pc[0] &= mask;
    pc[1] &= mask;
    fe_sub_raw(r, r, pc);
}

HD void fp_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[16];
    fe_mul_wide(t, a, b);
    fp_reduce_wide(r, t);
}

HD void fp_sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t t[16];
    fe_sqr_wide(t, a);
    fp_reduce_wide(r, t);
}

HD void fp_mul_small(uint32_t r[8], const uint32_t a[8], uint32_t k) {
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a[i] * k;
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    fp_fold_top(r, s, (uint32_t)c, 0);
}

HD void fp_neg(uint32_t r[8], const uint32_t a[8]) {
    uint32_t z[8];
    fe_set_small(z, 0);
    fp_sub(r, z, a);
}

// a^(2^k)
HD void fp_sqr_n(uint32_t r[8], const uint32_t a[8], int k) {
    fe_copy(r, a);
#pragma unroll 1
    for (int i = 0; i < k; i++) fp_sqr(r, r);
}

// a^((p+1)/4): the repunit addition chain of the plain engine's sqrt_p
// (253 squarings, 13 multiplications).
HD void fp_sqrt(uint32_t out[8], const uint32_t a[8]) {
    uint32_t r2[8], r4[8], r6[8], r8[8], r16[8], r22[8], r44[8], t[8];
    fp_sqr_n(t, a, 1);    fp_mul(r2, t, a);
    fp_sqr_n(t, r2, 2);   fp_mul(r4, t, r2);
    fp_sqr_n(t, r4, 2);   fp_mul(r6, t, r2);
    fp_sqr_n(t, r4, 4);   fp_mul(r8, t, r4);
    fp_sqr_n(t, r8, 8);   fp_mul(r16, t, r8);
    fp_sqr_n(t, r16, 6);  fp_mul(r22, t, r6);
    fp_sqr_n(t, r22, 22); fp_mul(r44, t, r22);
    uint32_t acc[8];
    fp_sqr_n(t, r44, 44); fp_mul(acc, t, r44);      // r88
    fp_sqr_n(t, acc, 88); fp_mul(acc, t, acc);      // r176
    fp_sqr_n(t, acc, 44); fp_mul(acc, t, r44);      // r220
    fp_sqr_n(t, acc, 2);  fp_mul(acc, t, r2);       // r222
    fp_sqr_n(t, acc, 1);  fp_mul(acc, t, a);        // r223
    fp_sqr_n(acc, acc, 1);                          // append 0
    fp_sqr_n(t, acc, 22); fp_mul(acc, t, r22);      // append 22 ones
    fp_sqr_n(acc, acc, 4);                          // append 0000
    fp_sqr_n(t, acc, 2);  fp_mul(acc, t, r2);       // append 11
    fp_sqr_n(out, acc, 2);                          // append 00
}

// a^(p-2) = a^-1 mod p (0 -> 0): libsecp256k1's addition chain over the
// blocks of ones of p - 2 (lengths 1, 2, 22 and 223), 255 squarings and
// 15 multiplications; the plain engine's inv_p, op for op.
HD void fp_inv(uint32_t out[8], const uint32_t a[8]) {
    uint32_t x2[8], x3[8], x11[8], x22[8], x44[8], acc[8], t[8];
    fp_sqr_n(t, a, 1);    fp_mul(x2, t, a);
    fp_sqr_n(t, x2, 1);   fp_mul(x3, t, a);
    fp_sqr_n(t, x3, 3);   fp_mul(acc, t, x3);       // x6
    fp_sqr_n(t, acc, 3);  fp_mul(acc, t, x3);       // x9
    fp_sqr_n(t, acc, 2);  fp_mul(x11, t, x2);
    fp_sqr_n(t, x11, 11); fp_mul(x22, t, x11);
    fp_sqr_n(t, x22, 22); fp_mul(x44, t, x22);
    fp_sqr_n(t, x44, 44); fp_mul(acc, t, x44);      // x88
    fp_sqr_n(t, acc, 88); fp_mul(acc, t, acc);      // x176
    fp_sqr_n(t, acc, 44); fp_mul(acc, t, x44);      // x220
    fp_sqr_n(t, acc, 3);  fp_mul(acc, t, x3);       // x223
    fp_sqr_n(t, acc, 23); fp_mul(acc, t, x22);
    fp_sqr_n(t, acc, 5);  fp_mul(acc, t, a);
    fp_sqr_n(t, acc, 3);  fp_mul(acc, t, x2);
    fp_sqr_n(t, acc, 2);  fp_mul(out, t, a);
}

// ---------------------------------------------------------------------------
// Arithmetic mod n (Montgomery, R = 2^256); inputs < n

// r = t / R mod n for t < n R (REDC: 8 rounds of t += m n 2^(32 i) with
// m = t[i] (-n^-1) mod 2^32; the carry of each round goes to the next),
// then one branchless conditional subtraction.  Clobbers t.
HD void fn_redc(uint32_t r[8], uint32_t t[16]) {
    uint32_t n[8];
    fe_set_n(n);
    uint32_t extra = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint32_t m = t[i] * SECP_N0INV;
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)m * n[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        c += (uint64_t)t[i + 8] + extra;
        t[i + 8] = (uint32_t)c;
        extra = (uint32_t)(c >> 32);
    }
    // extra * 2^256 + t[8..15] < 2n
    uint32_t d[8];
    uint32_t bw = fe_sub_raw(d, t + 8, n);
    fe_select(r, 0u - (extra | (bw ^ 1u)), d, t + 8);
}

HD void fn_mont_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[16];
    fe_mul_wide(t, a, b);
    fn_redc(r, t);
}

HD void fn_mont_sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t t[16];
    fe_sqr_wide(t, a);
    fn_redc(r, t);
}

// r = (a + b) mod n for a, b < n: the sum less n where it carries out
// or is at least n.
HD void fn_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t n[8], t[8];
    fe_set_n(n);
    uint32_t c = fe_add_raw(r, a, b);
    uint32_t bw = fe_sub_raw(t, r, n);
    fe_select(r, 0u - (c | (bw ^ 1u)), t, r);
}

HD void fn_mont_sqr_n(uint32_t r[8], const uint32_t a[8], int k) {
    fe_copy(r, a);
#pragma unroll 1
    for (int i = 0; i < k; i++) fn_mont_sqr(r, r);
}

// x^(n-2) in the Montgomery domain (x = a R -> a^-1 R for a != 0).  The
// chain is the plain engine's: a repunit ladder to x^(2^127 - 1), then a
// scan of the low 129 bits of n - 2 (255 squarings, 81 multiplications).
HD void fn_inv_mont(uint32_t acc[8], const uint32_t x[8]) {
    uint32_t t[8], r2[8], r3[8], r6[8], r7[8];
    fn_mont_sqr_n(t, x, 1);   fn_mont_mul(r2, t, x);
    fn_mont_sqr_n(t, r2, 1);  fn_mont_mul(r3, t, x);
    fn_mont_sqr_n(t, r3, 3);  fn_mont_mul(r6, t, r3);
    fn_mont_sqr_n(t, r6, 1);  fn_mont_mul(r7, t, x);
    fn_mont_sqr_n(t, r7, 7);  fn_mont_mul(acc, t, r7);   // r14
    fn_mont_sqr_n(t, acc, 1); fn_mont_mul(acc, t, x);    // r15
    fe_copy(r6, acc);
    fn_mont_sqr_n(t, acc, 15); fn_mont_mul(acc, t, r6);  // r30
    fn_mont_sqr_n(t, acc, 1); fn_mont_mul(acc, t, x);    // r31
    fe_copy(r6, acc);
    fn_mont_sqr_n(t, acc, 31); fn_mont_mul(acc, t, r6);  // r62
    fn_mont_sqr_n(t, acc, 1); fn_mont_mul(acc, t, x);    // r63
    fe_copy(r6, acc);
    fn_mont_sqr_n(t, acc, 63); fn_mont_mul(acc, t, r6);  // r126
    fn_mont_sqr_n(t, acc, 1); fn_mont_mul(acc, t, x);    // r127
    // bits 128..0 of n - 2: bit 128 is 0, then low128(n) - 2
    const uint32_t low[4] = {0xD036413Fu, 0xBFD25E8Cu, 0xAF48A03Bu,
                             0xBAAEDCE6u};
#pragma unroll 1
    for (int i = 128; i >= 0; i--) {
        fn_mont_sqr(acc, acc);
        uint32_t bit = i == 128 ? 0u : (low[i >> 5] >> (i & 31)) & 1u;
        if (bit) fn_mont_mul(acc, acc, x);
    }
}

// ---------------------------------------------------------------------------
// Batch inversion mod n (Montgomery's trick): w_i = s_i^-1 mod n for T
// values with one Fermat chain in all.  A value s = 0 mod n counts as 1 in
// the products and gets w = 0 (the convention of the plain inv_batch).

// a = (s mod n, or 1 where that is 0) * R; returns 1 where s = 0 mod n
HD uint32_t fn_batch_enter(uint32_t a[8], const uint32_t s[8]) {
    uint32_t n[8], r2[8], t[8];
    fe_set_n(n);
    fe_set_r2n(r2);
    fe_reduce_once(t, s, n);
    uint32_t z = fe_is_zero(t);
    t[0] |= z;
    fn_mont_mul(a, t, r2);
    return z;
}

// w = x * m (x in the Montgomery domain, m plain: w plain), 0 where zero
HD void fn_batch_out(uint32_t w[8], const uint32_t x[8], const uint32_t m[8],
                     uint32_t zero) {
    uint32_t z[8];
    fn_mont_mul(w, x, m);
    fe_set_small(z, 0);
    fe_select(w, 0u - zero, z, w);
}

// The sweep of Montgomery's trick over T nonzero values a_i = s_i R:
// exclusive prefix products into pre (8 T words), one chain for the
// inverse of the total, then back down: w_i = prefix_i * (prefix_i s_i)^-1
// = s_i^-1, plain.  w may not alias a.
HD void fn_inv_sweep(uint32_t *w, const uint32_t *a, uint32_t *pre, int T) {
    uint32_t acc[8], inv[8], one[8];
    fe_set_rn(acc);
    for (int i = 0; i < T; i++) {
        fe_copy(pre + 8 * i, acc);
        fn_mont_mul(acc, acc, a + 8 * i);
    }
    fn_inv_mont(inv, acc);
    fe_set_small(one, 1);
    fn_mont_mul(inv, inv, one);                 // leave the domain
    for (int i = T - 1; i >= 0; i--) {
        fn_mont_mul(w + 8 * i, pre + 8 * i, inv);
        fn_mont_mul(inv, inv, a + 8 * i);
    }
}

// w_i = s_i^-1 mod n (0 -> 0) for T values of any 256 bits, 8 words each;
// a and pre are scratch of 8 T words.  The prep kernel runs the same steps
// across a block: fn_batch_enter per thread, the products as warp scans,
// fn_inv_sweep over the warps' products, fn_batch_out per thread.
HD void fn_inv_batch(uint32_t *w, const uint32_t *s, uint32_t *a,
                     uint32_t *pre, int T) {
    for (int i = 0; i < T; i++) fn_batch_enter(a + 8 * i, s + 8 * i);
    fn_inv_sweep(w, a, pre, T);
    for (int i = 0; i < T; i++) {
        uint32_t n[8], t[8], z[8];
        fe_set_n(n);
        fe_reduce_once(t, s + 8 * i, n);
        fe_set_small(z, 0);
        fe_select(w + 8 * i, 0u - fe_is_zero(t), z, w + 8 * i);
    }
}

// ---------------------------------------------------------------------------
// Batch inversion mod p (Montgomery's trick), the same steps with plain
// products: z_i^-1 mod p for T values with one Fermat chain in all.  A
// value 0 mod p counts as 1 in the products and gets 0 (as fp_inv(0)), so
// a point at infinity (Z = 0) gives x = y = 0 and leaves the others as
// they are.

// a = (z mod p, or 1 where that is 0); returns 1 where z = 0 mod p
HD uint32_t fp_batch_enter(uint32_t a[8], const uint32_t z[8]) {
    uint32_t p[8];
    fe_set_p(p);
    fe_reduce_once(a, z, p);
    const uint32_t zero = fe_is_zero(a);
    a[0] |= zero;
    return zero;
}

// w = x * m, 0 where zero
HD void fp_batch_out(uint32_t w[8], const uint32_t x[8], const uint32_t m[8],
                     uint32_t zero) {
    uint32_t z[8];
    fp_mul(w, x, m);
    fe_set_small(z, 0);
    fe_select(w, 0u - zero, z, w);
}

// The sweep over T nonzero values a_i: exclusive prefix products into pre
// (8 T words), one chain for the inverse of the total, then back down:
// w_i = prefix_i * (prefix_i a_i)^-1 = a_i^-1.  w may not alias a.
HD void fp_inv_sweep(uint32_t *w, const uint32_t *a, uint32_t *pre, int T) {
    uint32_t acc[8], inv[8];
    fe_set_small(acc, 1);
    for (int i = 0; i < T; i++) {
        fe_copy(pre + 8 * i, acc);
        fp_mul(acc, acc, a + 8 * i);
    }
    fp_inv(inv, acc);
    for (int i = T - 1; i >= 0; i--) {
        fp_mul(w + 8 * i, pre + 8 * i, inv);
        fp_mul(inv, inv, a + 8 * i);
    }
}

// w_i = z_i^-1 mod p (0 -> 0) for T values of any 256 bits, 8 words each;
// a and pre are scratch of 8 T words.  S1 and S2 run the same steps
// across a block (block_inv below).
HD void fp_inv_batch(uint32_t *w, const uint32_t *z, uint32_t *a,
                     uint32_t *pre, int T) {
    for (int i = 0; i < T; i++) fp_batch_enter(a + 8 * i, z + 8 * i);
    fp_inv_sweep(w, a, pre, T);
    for (int i = 0; i < T; i++) {
        uint32_t p[8], t[8], zero[8];
        fe_set_p(p);
        fe_reduce_once(t, z + 8 * i, p);
        fe_set_small(zero, 0);
        fe_select(w + 8 * i, 0u - fe_is_zero(t), zero, w + 8 * i);
    }
}

#ifdef __CUDACC__
// The two moduli of a batch inversion: how a value enters the products,
// the products' 1, the product, the sweep over the warps' products, and
// the way out (the inverse plain in both).
struct mod_p {
    HD static uint32_t enter(uint32_t a[8], const uint32_t v[8]) {
        return fp_batch_enter(a, v);
    }
    HD static void one(uint32_t r[8]) { fe_set_small(r, 1); }
    HD static void mul(uint32_t r[8], const uint32_t a[8],
                       const uint32_t b[8]) { fp_mul(r, a, b); }
    HD static void sweep(uint32_t *w, const uint32_t *a, uint32_t *pre,
                         int T) { fp_inv_sweep(w, a, pre, T); }
    HD static void out(uint32_t w[8], const uint32_t x[8],
                       const uint32_t m[8], uint32_t zero) {
        fp_batch_out(w, x, m, zero);
    }
};
struct mod_n {
    HD static uint32_t enter(uint32_t a[8], const uint32_t v[8]) {
        return fn_batch_enter(a, v);
    }
    HD static void one(uint32_t r[8]) { fe_set_rn(r); }
    HD static void mul(uint32_t r[8], const uint32_t a[8],
                       const uint32_t b[8]) { fn_mont_mul(r, a, b); }
    HD static void sweep(uint32_t *w, const uint32_t *a, uint32_t *pre,
                         int T) { fn_inv_sweep(w, a, pre, T); }
    HD static void out(uint32_t w[8], const uint32_t x[8],
                       const uint32_t m[8], uint32_t zero) {
        fn_batch_out(w, x, m, zero);
    }
};

// A warp's part of a block's batch inversion: the inclusive prefix and
// suffix products of the warp's 32 entered values (5 shuffle steps each),
// the warp's product to warp_prod (by lane 31), and x, the product of the
// other 31 values.  Every lane of the warp takes part.
template <class M>
__device__ __forceinline__ void warp_scan_others(uint32_t x[8],
                                                 const uint32_t a[8],
                                                 uint32_t *warp_prod) {
    const int lane = threadIdx.x & 31;
    uint32_t pre[8], suf[8], up[8], dn[8];
    fe_copy(pre, a);
    fe_copy(suf, a);
#pragma unroll 1
    for (int dist = 1; dist < 32; dist <<= 1) {
#pragma unroll
        for (int k = 0; k < 8; k++) {
            up[k] = __shfl_up_sync(0xFFFFFFFFu, pre[k], dist);
            dn[k] = __shfl_down_sync(0xFFFFFFFFu, suf[k], dist);
        }
        if (lane >= dist) M::mul(pre, up, pre);
        if (lane + dist < 32) M::mul(suf, suf, dn);
    }
    if (lane == 31) fe_copy(warp_prod, pre);
#pragma unroll
    for (int k = 0; k < 8; k++) {
        up[k] = __shfl_up_sync(0xFFFFFFFFu, pre[k], 1);
        dn[k] = __shfl_down_sync(0xFFFFFFFFu, suf[k], 1);
    }
    if (lane == 0) M::one(up);
    if (lane == 31) M::one(dn);
    M::mul(x, up, dn);
}

// Shared memory of a block's batch inversion over W warps: the warps'
// products, their inverses and the sweep's prefix products.
template <int W> struct block_inv_smem {
    uint32_t prod[8 * W], inv[8 * W], pre[8 * W];
};

// w = v^-1 (0 -> 0) for each thread's v in the block's first nw warps
// (1 <= nw <= W), by Montgomery's trick: warp scans, one Fermat chain on
// thread 0 for the nw warp products, then w = (the product of the warp's
// other values) * (the warp's product)^-1.  Every thread of the block
// calls it (it synchronizes the block twice); the warps from nw on take
// no part and their w is not set, so a block with few values pays for a
// sweep over the warps that hold them.  Lanes of those warps without a
// value pass v = 1.
template <class M, int W>
__device__ __forceinline__ void block_inv(uint32_t w[8], const uint32_t v[8],
                                          int nw, block_inv_smem<W> &sm) {
    const int wid = threadIdx.x >> 5;
    const bool live = wid < nw;
    uint32_t a[8], x[8], zero = 0;
    if (live) {
        zero = M::enter(a, v);
        warp_scan_others<M>(x, a, sm.prod + 8 * wid);
    }
    __syncthreads();
    if (threadIdx.x == 0) M::sweep(sm.inv, sm.prod, sm.pre, nw);
    __syncthreads();
    if (live) M::out(w, x, sm.inv + 8 * wid, zero);
}

// The warps that hold the first n threads of a block of W warps.
HD int warps_for(int n, int W) {
    const int nw = (n + 31) / 32;
    return nw < W ? nw : W;
}
#endif

// ---------------------------------------------------------------------------
// Points: projective (X:Y:Z), RCB complete formulas for a = 0

struct pt {
    uint32_t x[8], y[8], z[8];
};

HD void pt_set_inf(pt &p) {
    fe_set_small(p.x, 0);
    fe_set_small(p.y, 1);
    fe_set_small(p.z, 0);
}

// RCB complete doubling (alg 9): the plain engine's point_double, op for op.
HD void pt_double(pt &o, const pt &p) {
    uint32_t t0[8], t1[8], t2[8], X3[8], Y3[8], Z3[8];
    fp_sqr(t0, p.y);
    fp_add(Z3, t0, t0);
    fp_add(Z3, Z3, Z3);
    fp_add(Z3, Z3, Z3);
    fp_mul(t1, p.y, p.z);
    fp_sqr(t2, p.z);
    fp_mul_small(t2, t2, SECP_B3);
    fp_mul(X3, t2, Z3);
    fp_add(Y3, t0, t2);
    fp_mul(Z3, t1, Z3);
    fp_add(t1, t2, t2);
    fp_add(t2, t1, t2);
    fp_sub(t0, t0, t2);
    fp_mul(Y3, t0, Y3);
    fp_add(Y3, X3, Y3);
    fp_mul(t1, p.x, p.y);
    fp_mul(X3, t0, t1);
    fp_add(X3, X3, X3);
    fe_copy(o.x, X3);
    fe_copy(o.y, Y3);
    fe_copy(o.z, Z3);
}

// RCB complete addition (alg 7): the plain engine's point_add, op for op.
HD void pt_add(pt &o, const pt &p, const pt &q) {
    uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
    fp_mul(t0, p.x, q.x);
    fp_mul(t1, p.y, q.y);
    fp_mul(t2, p.z, q.z);
    fp_add(t3, p.x, p.y);
    fp_add(t4, q.x, q.y);
    fp_mul(t3, t3, t4);
    fp_add(t4, t0, t1);
    fp_sub(t3, t3, t4);
    fp_add(t4, p.y, p.z);
    fp_add(X3, q.y, q.z);
    fp_mul(t4, t4, X3);
    fp_add(X3, t1, t2);
    fp_sub(t4, t4, X3);
    fp_add(X3, p.x, p.z);
    fp_add(Y3, q.x, q.z);
    fp_mul(X3, X3, Y3);
    fp_add(Y3, t0, t2);
    fp_sub(Y3, X3, Y3);
    fp_add(X3, t0, t0);
    fp_add(t0, X3, t0);
    fp_mul_small(t2, t2, SECP_B3);
    fp_add(Z3, t1, t2);
    fp_sub(t1, t1, t2);
    fp_mul_small(Y3, Y3, SECP_B3);
    fp_mul(X3, t4, Y3);
    fp_mul(t2, t3, t1);
    fp_sub(X3, t2, X3);
    fp_mul(Y3, Y3, t0);
    fp_mul(t1, t1, Z3);
    fp_add(Y3, t1, Y3);
    fp_mul(t0, t0, t3);
    fp_mul(Z3, Z3, t4);
    fp_add(Z3, Z3, t0);
    fe_copy(o.x, X3);
    fe_copy(o.y, Y3);
    fe_copy(o.z, Z3);
}

// pt_add with q = (qx : qy : 1): the same op sequence with q.z = 1
// substituted, so t2 = p.z * 1 is p.z itself (no product) and q.z's sums
// add the constant 1.  For a canonical p.z every output is the residue
// pt_add gives, on or off the curve.
HD void pt_add_z1(pt &o, const pt &p, const uint32_t qx[8],
                  const uint32_t qy[8]) {
    uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8], one[8];
    fe_set_small(one, 1);
    fp_mul(t0, p.x, qx);
    fp_mul(t1, p.y, qy);
    fe_copy(t2, p.z);
    fp_add(t3, p.x, p.y);
    fp_add(t4, qx, qy);
    fp_mul(t3, t3, t4);
    fp_add(t4, t0, t1);
    fp_sub(t3, t3, t4);
    fp_add(t4, p.y, p.z);
    fp_add(X3, qy, one);
    fp_mul(t4, t4, X3);
    fp_add(X3, t1, t2);
    fp_sub(t4, t4, X3);
    fp_add(X3, p.x, p.z);
    fp_add(Y3, qx, one);
    fp_mul(X3, X3, Y3);
    fp_add(Y3, t0, t2);
    fp_sub(Y3, X3, Y3);
    fp_add(X3, t0, t0);
    fp_add(t0, X3, t0);
    fp_mul_small(t2, t2, SECP_B3);
    fp_add(Z3, t1, t2);
    fp_sub(t1, t1, t2);
    fp_mul_small(Y3, Y3, SECP_B3);
    fp_mul(X3, t4, Y3);
    fp_mul(t2, t3, t1);
    fp_sub(X3, t2, X3);
    fp_mul(Y3, Y3, t0);
    fp_mul(t1, t1, Z3);
    fp_add(Y3, t1, Y3);
    fp_mul(t0, t0, t3);
    fp_mul(Z3, Z3, t4);
    fp_add(Z3, Z3, t0);
    fe_copy(o.x, X3);
    fe_copy(o.y, Y3);
    fe_copy(o.z, Z3);
}

// ---------------------------------------------------------------------------
// Strided access: word k of element i of a limbs-first (8, B) plane lives
// at base[k * stride + i]; callers pass base already offset by i.

HD void fe_load(uint32_t r[8], const uint32_t *base, long long stride) {
#pragma unroll
    for (int k = 0; k < 8; k++) r[k] = base[k * stride];
}

HD void fe_store(uint32_t *base, long long stride, const uint32_t a[8]) {
#pragma unroll
    for (int k = 0; k < 8; k++) base[k * stride] = a[k];
}

// ---------------------------------------------------------------------------
// The per-signature bodies of the six kernels

// K1's per-signature part: y = sqrt(x^3 + 7), d = y^2 - (x^3 + 7).  The
// inverse w = s^-1 mod n is the block's batch inversion (fn_inv_batch).
HD void verify_prep_sqrt_one(const uint32_t qx[8], uint32_t y[8],
                             uint32_t d[8]) {
    uint32_t p[8], x[8], t[8], y2[8], seven[8];
    fe_set_p(p);
    fe_reduce_once(x, qx, p);
    fp_sqr(t, x);
    fp_mul(t, t, x);
    fe_set_small(seven, 7);
    fp_add(y2, t, seven);
    fp_sqrt(y, y2);
    fp_sqr(t, y);
    fp_sub(d, t, y2);
}

// K2: tables of one key.  Entry (c, v, k) of the (6, 16, 8) table block
// is at out[((c * 16 + v) * 8 + k) * stride]; c = 0..2 are lo X, Y, Z,
// c = 3..5 hi X, Y, Z.  lo[v] = v * (bx, byl, 1); hi[v] = (beta * X_v,
// +-Y_v, Z_v) with Y negated where sflip is set; entry 0 = (0:1:0).  The
// base's Z is 1, so each of the 14 additions is pt_add_z1.
HD void tab_store(uint32_t *out, long long stride, int c, int v,
                  const uint32_t a[8]) {
    fe_store(out + (long long)((c * 16 + v) * 8) * stride, stride, a);
}

HD void build_tables_one(const uint32_t bx[8], const uint32_t byl[8],
                         uint32_t sflip, uint32_t *out, long long stride) {
    uint32_t p[8], beta[8], t[8], x[8], y[8];
    fe_set_p(p);
    fe_set_beta(beta);
    pt acc, inf;
    fe_reduce_once(x, bx, p);
    fe_reduce_once(y, byl, p);
    pt_set_inf(inf);
    for (int c = 0; c < 2; c++) {
        tab_store(out, stride, 3 * c + 0, 0, inf.x);
        tab_store(out, stride, 3 * c + 1, 0, inf.y);
        tab_store(out, stride, 3 * c + 2, 0, inf.z);
    }
    fe_copy(acc.x, x);
    fe_copy(acc.y, y);
    fe_set_small(acc.z, 1);
#pragma unroll 1
    for (int v = 1; v < 16; v++) {
        if (v > 1) pt_add_z1(acc, acc, x, y);
        tab_store(out, stride, 0, v, acc.x);
        tab_store(out, stride, 1, v, acc.y);
        tab_store(out, stride, 2, v, acc.z);
        fp_mul(t, acc.x, beta);
        tab_store(out, stride, 3, v, t);
        if (sflip) {
            fp_neg(t, acc.y);
            tab_store(out, stride, 4, v, t);
        } else {
            tab_store(out, stride, 4, v, acc.y);
        }
        tab_store(out, stride, 5, v, acc.z);
    }
}

#define GLV_WINDOWS 33

// The scan's prefetch slot: the 2 + n_g points one window adds (Qlo[d2l],
// Qhi[d2h], then the n_g fixed-base points) as 24 words each; word k of
// the slot at slot[k * step].  On the device the slot is the thread's
// column of a shared-memory block (step = threads a block, so a warp's
// accesses fall on 32 banks) and each word arrives by a 4-byte cp.async;
// on the host it is a plain array.
#define GLV_SLOT_WORDS(ng) (24 * (2 + (ng)))

HD void slot_fetch(uint32_t *dst, const uint32_t *src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
#else
    *dst = *src;
#endif
}

// Wait for this thread's copies; each thread reads only its own slot.
HD void slot_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Slot points 0 and 1: entry dl of the lo table and dh of the hi table.
HD void tab_fetch(uint32_t *slot, int step, const uint32_t *tab,
                  long long stride, int dl, int dh) {
    const long long plane = (long long)16 * 8 * stride;   // one coordinate
    const uint32_t *lo = tab + (long long)(dl * 8) * stride;
    const uint32_t *hi = tab + (long long)((48 + dh) * 8) * stride;
#pragma unroll
    for (int c = 0; c < 3; c++) {
#pragma unroll
        for (int k = 0; k < 8; k++) {
            slot_fetch(slot + (c * 8 + k) * step, lo + c * plane + k * stride);
            slot_fetch(slot + (24 + c * 8 + k) * step,
                       hi + c * plane + k * stride);
        }
    }
}

// A window's n_g fixed-base points.  n_g = 1 (K3): one entry of the
// 1024-entry joint G / phi(G) table (X, Y, Z as 3 x 8 words), selected by
// a (33, B) index plane.  n_g = 2 (K4): row w of the pre-selected,
// pre-signed G and of the phi(G) points, (33, 3, 8, B) word planes.
// Callers pass the planes offset by the signature.
template <int NG> struct glv_fixed;
template <> struct glv_fixed<1> {
    const int32_t *gidx;
    const uint32_t *jt;
};
template <> struct glv_fixed<2> {
    const uint32_t *g1, *g2;
};

// What selects window w's fixed-base points: its joint index, or w itself.
HD int fixed_sel(const glv_fixed<1> &f, int w, long long stride) {
    return f.gidx[w * stride];
}
HD int fixed_sel(const glv_fixed<2> &, int w, long long) { return w; }

HD void fixed_fetch(uint32_t *slot, int step, const glv_fixed<1> &f, int g,
                    long long) {
    const uint32_t *gj = f.jt + (g & 1023) * 24;
#pragma unroll
    for (int k = 0; k < 24; k++) slot_fetch(slot + k * step, gj + k);
}

HD void fixed_fetch(uint32_t *slot, int step, const glv_fixed<2> &f, int w,
                    long long stride) {
    const long long row = (long long)w * 24 * stride;
#pragma unroll
    for (int k = 0; k < 24; k++) {
        slot_fetch(slot + k * step, f.g1 + row + k * stride);
        slot_fetch(slot + (24 + k) * step, f.g2 + row + k * stride);
    }
}

HD void slot_point(pt &q, const uint32_t *slot, int step, int e) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
        q.x[k] = slot[(e * 24 + k) * step];
        q.y[k] = slot[(e * 24 + 8 + k) * step];
        q.z[k] = slot[(e * 24 + 16 + k) * step];
    }
}

// K3 (n_g = 1) and K4 (n_g = 2), one body as the TPU's
// _make_glv_kernel(n_g) is: the 33-window GLV scan from infinity,
// acc = 16 acc + Qlo[d2l] + Qhi[d2h] + the window's n_g fixed-base
// points, added in that order.  Digits are (33, B) planes, MSB first; tab
// is K2's (6, 16, 8) table block.  A window's points do not depend on the
// accumulator: their copies start before its four doublings and are
// waited for after them, and the next window's digits load meanwhile.
template <int NG>
HD void glv_scan_one(const int32_t *d2l, const int32_t *d2h,
                     long long stride, const uint32_t *tab,
                     const glv_fixed<NG> &fx, uint32_t *slot, int step,
                     pt &acc) {
    pt q;
    pt_set_inf(acc);
    int dl = d2l[0], dh = d2h[0], g = fixed_sel(fx, 0, stride);
#pragma unroll 1
    for (int w = 0; w < GLV_WINDOWS; w++) {
        tab_fetch(slot, step, tab, stride, dl & 15, dh & 15);
        fixed_fetch(slot + 48 * step, step, fx, g, stride);
        if (w + 1 < GLV_WINDOWS) {
            dl = d2l[(w + 1) * stride];
            dh = d2h[(w + 1) * stride];
            g = fixed_sel(fx, w + 1, stride);
        }
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        slot_wait();
#pragma unroll 1
        for (int e = 0; e < 2 + NG; e++) {
            slot_point(q, slot, step, e);
            pt_add(acc, acc, q);
        }
    }
}

#define DUAL_WINDOWS 64

// The 64-window scans' prefetch slot: the two points a window adds, Q then
// G, 24 words each, in a block's slot array of DUAL_SLOT_WORDS words a
// thread.  G, and Q where it comes from word planes, lie word by word
// (word k of thread t's point e at slots[(24 e + k) step + t], so a warp's
// accesses fall on 32 banks); K5's Q lies in 16-byte chunks (chunk c of
// thread t at slots[4 (c step + t)], a warp's 16-byte reads on
// consecutive addresses).  step is the threads of a block on the device,
// t the thread's index; the host passes any step > t.
#define DUAL_SLOT_WORDS 48

HD void slot_fetch16(uint32_t *dst, const uint32_t *src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
                 : "memory");
#else
    for (int k = 0; k < 4; k++) dst[k] = src[k];
#endif
}

// Entry j of (n, 3, 8, B) word planes into a thread's slot column (word k
// at col[k * step]); callers pass the planes offset by the signature.
HD void plane_fetch(uint32_t *col, int step, const uint32_t *planes,
                    long long stride, int j) {
    const uint32_t *b = planes + (long long)j * 24 * stride;
#pragma unroll
    for (int k = 0; k < 24; k++) slot_fetch(col + k * step, b + k * stride);
}

// What selects window w's Q point, and where it comes from.  K5: entry
// d2[w] of the key's table v*Q, signature-major (B, 16, 3, 8) words, so
// an entry is 24 contiguous words; callers pass the digit plane offset by
// the signature and the table at the signature's 384 words.  K6: row w of
// the pre-selected (64, 3, 8, B) Q planes, offset by the signature.
#define DUAL_QTAB_WORDS (16 * 24)
struct dual_q_table {
    const int32_t *d2;
    const uint32_t *qtab;
};
struct dual_q_planes {
    const uint32_t *qs;
};

HD int q_sel(const dual_q_table &f, int w, long long stride) {
    return f.d2[w * stride] & 15;
}
HD int q_sel(const dual_q_planes &, int w, long long) { return w; }

HD void q_fetch(uint32_t *slots, int t, int step, const dual_q_table &f,
                int j, long long) {
    const uint32_t *e = f.qtab + j * 24;
#pragma unroll
    for (int c = 0; c < 6; c++)
        slot_fetch16(slots + 4 * (c * step + t), e + 4 * c);
}
HD void q_fetch(uint32_t *slots, int t, int step, const dual_q_planes &f,
                int j, long long stride) {
    plane_fetch(slots + t, step, f.qs, stride, j);
}

HD void q_point(pt &q, const uint32_t *slots, int t, int step,
                const dual_q_table &) {
    uint32_t w[24];
#pragma unroll
    for (int c = 0; c < 6; c++) {
        const uint32_t *s = slots + 4 * (c * step + t);
#ifdef __CUDA_ARCH__
        const uint4 v = *reinterpret_cast<const uint4 *>(s);
        w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
#else
        for (int k = 0; k < 4; k++) w[4 * c + k] = s[k];
#endif
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        q.x[k] = w[k];
        q.y[k] = w[8 + k];
        q.z[k] = w[16 + k];
    }
}
HD void q_point(pt &q, const uint32_t *slots, int t, int step,
                const dual_q_planes &) {
    slot_point(q, slots + t, step, 0);
}

// K5 (dual_q_table) and K6 (dual_q_planes), one body: the 64-window scan
// from infinity, acc = 16 acc + Q_w + G[w], added in that order, as the
// TPU's _dual_mul_kernel_v2 and _dual_mul_kernel add them.  gs holds the
// pre-selected G points, (64, 3, 8, B) planes offset by the signature.  A
// window's two points do not depend on the accumulator: their copies start
// before its four doublings and are waited for after them, and the next
// window's Q selector loads meanwhile.  The two additions go through one
// loop, so the code holds one copy of pt_add, as it holds one of
// pt_double: with a second copy the kernel is about 11,100 SASS
// instructions instead of 7,100 and took 3-16 % longer on the H100
// (kernel_ablation.py, steps bounds and one_add).
template <class Q>
HD void dual_scan_one(const Q &qsel, const uint32_t *gs, long long stride,
                      uint32_t *slots, int t, int step, pt &acc) {
    pt q;
    uint32_t *gcol = slots + 24 * step + t;
    pt_set_inf(acc);
    int j = q_sel(qsel, 0, stride);
#pragma unroll 1
    for (int w = 0; w < DUAL_WINDOWS; w++) {
        q_fetch(slots, t, step, qsel, j, stride);
        plane_fetch(gcol, step, gs, stride, w);
        if (w + 1 < DUAL_WINDOWS) j = q_sel(qsel, w + 1, stride);
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        slot_wait();
#pragma unroll 1
        for (int e = 0; e < 2; e++) {
            if (e == 0)
                q_point(q, slots, t, step, qsel);
            else
                slot_point(q, gcol, step, 0);
            pt_add(acc, acc, q);
        }
    }
}

// ---------------------------------------------------------------------------
// Fixed-base k*G by the comb (S1, S2)

#define COMB_WINDOWS 64
#define COMB_ENTRY_WORDS 16                   // affine x, then y
#define COMB_ROW_WORDS (15 * COMB_ENTRY_WORDS)
#define COMB_TABLE_BYTES (COMB_WINDOWS * COMB_ROW_WORDS * 4)   // 61,440

// 8 words of the comb table (src 16-byte aligned): two 16-byte loads on
// the device, through the read-only data cache from global memory (ldg),
// else plain loads (the block's copy in shared memory).
template <bool LDG> HD void comb_load(uint32_t r[8], const uint32_t *src) {
#ifdef __CUDA_ARCH__
    const uint4 *v = reinterpret_cast<const uint4 *>(src);
    const uint4 a = LDG ? __ldg(v) : v[0], b = LDG ? __ldg(v + 1) : v[1];
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
    for (int k = 0; k < 8; k++) r[k] = src[k];
#endif
}

// Digit j (bits 4j .. 4j + 3) of k; the word is selected without an
// index into k, so k stays in registers.
HD uint32_t comb_digit(const uint32_t k[8], int j) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) w = (i == (j >> 3)) ? k[i] : w;
    return (w >> (4 * (j & 7))) & 15u;
}

// acc = k*G for any 256-bit k: the sum over the 64 windows j of
// d_j * 2^(4j) * G, d_j the 4-bit digits of k.  comb is the (64, 15, 2, 8)
// word table of the affine (x, y) of v * 2^(4j) * G, v = 1..15; each
// window is one mixed addition (pt_add_z1) of entry (j, d_j - 1).  A digit
// 0 adds nothing: the table holds no point at infinity, which a mixed
// addition could not take.  The loop holds one copy of pt_add_z1; the
// threads of a warp read entries of the same row j in each step.  LDG:
// comb is the table in global memory, read through the read-only cache;
// else the block's copy in shared memory (comb_table_to_shared).
template <bool LDG = true>
HD void comb_mul_one(pt &acc, const uint32_t k[8], const uint32_t *comb) {
    uint32_t x[8], y[8];
    pt_set_inf(acc);
#pragma unroll 1
    for (int j = 0; j < COMB_WINDOWS; j++) {
        const uint32_t d = comb_digit(k, j);
        if (d == 0) continue;
        const uint32_t *e = comb + j * COMB_ROW_WORDS
                            + (int)(d - 1) * COMB_ENTRY_WORDS;
        comb_load<LDG>(x, e);
        comb_load<LDG>(y, e + 8);
        pt_add_z1(acc, acc, x, y);
    }
}

#ifdef __CUDACC__
// The comb table into the block's shared memory (dst, COMB_TABLE_BYTES,
// 16-byte aligned) by one bulk asynchronous copy (cp.async.bulk, the
// TMA's one-dimensional form) that completes on the mbarrier bar; every
// thread of the block calls it and returns when the table has landed.
__device__ __forceinline__ void comb_table_to_shared(uint32_t *dst,
                                                     const uint32_t *src,
                                                     uint64_t *bar) {
#ifdef __CUDA_ARCH__
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(b), "r"(COMB_TABLE_BYTES) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                     "complete_tx::bytes [%0], [%1], %2, [%3];"
                     :: "r"((uint32_t)__cvta_generic_to_shared(dst)),
                        "l"(src), "r"(COMB_TABLE_BYTES), "r"(b)
                     : "memory");
    }
    __syncthreads();                  // the barrier is set up before the wait
    asm volatile("{\n.reg .pred p;\nWAIT%=:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
                 "@!p bra WAIT%=;\n}" :: "r"(b) : "memory");
#else
    if (threadIdx.x == 0)
        for (int i = 0; i < COMB_TABLE_BYTES / 4; i++) dst[i] = src[i];
    __syncthreads();
#endif
}
#endif

// ---------------------------------------------------------------------------
// S2: a tile of rows signed in candidate rounds, compacted across a block
//
// A block signs a tile of up to T rows.  Every row starts pending with no
// candidate tried.  In a round the p pending rows are packed in list[0,
// p), and thread t takes pending row t mod p with its candidate nxt + t /
// p (a job), nxt being the row's first candidate not yet tried: the low p
// threads take each row's next candidate, and the threads above take the
// candidates after it (fill), as far as there are C.  A job computes
// R = k*G and, after the block's batch inversion mod p, r = x(R) mod n
// and whether r is low (bit 255 clear) and nonzero.  Thread i < p then
// decides pending row i from its jobs in candidate order: the first low r
// is taken (grind); where every candidate is tried and none is low,
// candidate 0's; else the row stays pending and is packed again.  Every
// round tries at least one more candidate of each pending row, so a tile
// takes at most C rounds.  The device kernel (ecdsa_sign.cu) runs the
// steps below with barriers between them; a host test runs them as loops
// over the threads.

// A tile's state in shared memory.  r: a row's r, candidate 0's until a
// low one (word k of row i at r[k T + i]); jr: a job's r (word k of
// thread t's at jr[k T + t]).
template <int T> struct sign_tile {
    uint32_t r[8 * T];
    uint32_t jr[8 * T];
    uint16_t list[T];     // the pending rows, packed
    uint8_t nxt[T];       // a row's first candidate not yet tried
    uint8_t sel[T];       // a decided row's candidate
    uint8_t grind[T];     // a decided row's r is low
    uint8_t jlow[T];      // a job's r is low and nonzero
    int p;                // pending rows
};

// A tile of n rows, all pending, none tried: thread t's part.
template <int T> HD void sign_tile_start(sign_tile<T> &s, int t, int n) {
    if (t < n) {
        s.list[t] = (uint16_t)t;
        s.nxt[t] = 0;
    }
    if (t == 0) s.p = n;
}

// Thread t's job in a round with p > 0 rows pending: the row (its index in
// the tile), or -1 for none, and the candidate.
template <int C, int T> HD int sign_job(const sign_tile<T> &s, int t, int p,
                                        int &cand) {
    const int level = t / p;
    const int row = s.list[t - level * p];
    cand = s.nxt[row] + level;
    return cand < C ? row : -1;
}

// A job's r = x(R) mod n from X and zi = Z^-1 mod p of R = (X : Y : Z),
// and whether it is low and nonzero, into thread t's slot (x < p < 2n: one
// conditional subtraction).
template <int T> HD void sign_job_r(sign_tile<T> &s, int t,
                                    const uint32_t X[8],
                                    const uint32_t zi[8]) {
    uint32_t n[8], x[8], rc[8];
    fe_set_n(n);
    fp_mul(x, X, zi);
    fe_reduce_once(rc, x, n);
#pragma unroll
    for (int k = 0; k < 8; k++) s.jr[k * T + t] = rc[k];
    s.jlow[t] = (uint8_t)(((rc[7] >> 31) ^ 1u) & (fe_is_zero(rc) ^ 1u));
}

// Thread t < p decides pending row list[t] (returned in row) from its jobs
// of the round, at threads t, t + p, ... in candidate order; returns 1
// where the row stays pending.
template <int C, int T> HD uint32_t sign_decide(sign_tile<T> &s, int t,
                                                int p, int &row) {
    row = s.list[t];
    const int nx = s.nxt[row];
    const int reach = (T - 1 - t) / p + 1;
    const int jobs = C - nx < reach ? C - nx : reach;
    int j = 0;
    while (j < jobs && !s.jlow[t + j * p]) j++;
    if (nx == 0) {                            // candidate 0's r
#pragma unroll
        for (int k = 0; k < 8; k++) s.r[k * T + row] = s.jr[k * T + t];
    }
    if (j < jobs) {
        const int src = t + j * p;
#pragma unroll
        for (int k = 0; k < 8; k++) s.r[k * T + row] = s.jr[k * T + src];
        s.sel[row] = (uint8_t)(nx + j);
        s.grind[row] = 1;
        return 0;
    }
    s.nxt[row] = (uint8_t)(nx + jobs);
    if (nx + jobs < C) return 1;
    s.sel[row] = 0;
    s.grind[row] = 0;
    return 0;
}

// The end of a row: s = k^-1 (z + r d) mod n by Montgomery products (R =
// 2^256) from kinv = k^-1 R mod n: z and d reduced mod n once, r R = r
// (R^2 mod n), r d = (r R) d, s = kinv (z + r d).  Low-S: s > (n - 1) / 2
// becomes n - s.  ok: r and s nonzero.
HD void sign_finish(const uint32_t z[8], const uint32_t d[8],
                    const uint32_t r[8], const uint32_t kinv[8],
                    uint32_t s[8], uint32_t &ok) {
    uint32_t n[8], r2[8], t[8], u[8], zr[8], dr[8], half[8], neg[8];
    fe_set_n(n);
    fe_set_r2n(r2);
    fe_reduce_once(zr, z, n);
    fe_reduce_once(dr, d, n);
    fn_mont_mul(t, r, r2);            // r R
    fn_mont_mul(t, t, dr);            // r d
    fn_add(u, zr, t);                 // z + r d
    fn_mont_mul(s, kinv, u);          // k^-1 (z + r d)
#pragma unroll
    for (int i = 0; i < 7; i++)       // (n - 1) / 2 = n >> 1
        half[i] = (n[i] >> 1) | (n[i + 1] << 31);
    half[7] = n[7] >> 1;
    const uint32_t high = fe_sub_raw(t, half, s);
    fe_sub_raw(neg, n, s);
    fe_select(s, 0u - high, neg, s);
    ok = (fe_is_zero(r) ^ 1u) & (fe_is_zero(s) ^ 1u);
}

#ifdef __CUDACC__
// Blocks of a kernel an SM holds at `threads` a block and `smem` bytes of
// dynamic shared memory (the occupancy query), or -1 on an error.  Where
// smem is over the 48 KB a kernel may take without asking, it first
// allows the kernel that much, which its launch needs too.
static int sm_blocks(const void *kernel, int threads, int smem) {
    int n = 0;
    if ((smem > 48 * 1024
         && cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem) != cudaSuccess)
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                         smem) != cudaSuccess)
        return -1;
    return n;
}

// Blocks of a kernel the card holds at once: its SMs times sm_blocks,
// cached per device in cache (64 entries, zeroed, one array a kernel); 0
// on an error.
static int card_blocks(const void *kernel, int threads, int smem,
                       int *cache) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
        return 0;
    if (cache[dev] == 0
        && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               == cudaSuccess) {
        const int per_sm = sm_blocks(kernel, threads, smem);
        cache[dev] = per_sm > 0 ? sms * per_sm : 0;
    }
    return cache[dev];
}

// S1's and S2's launch geometry: B rows over at most cap blocks of
// `threads`, each block looping over tiles of `rows` (the rows spread
// over every block, at most a block's threads), on a grid of no more
// blocks than tiles.  rows and grid are 0 where B or cap is.
struct tiling { int rows, grid; };
static tiling spread(int B, int cap, int threads) {
    if (B <= 0 || cap <= 0) return {0, 0};
    int rows = (B + cap - 1) / cap;
    rows = rows < threads ? rows : threads;
    const int tiles = (B + rows - 1) / rows;
    return {rows, tiles < cap ? tiles : cap};
}
#endif
