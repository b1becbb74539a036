// secp256k1 field, scalar and point arithmetic for the verify kernels.
//
// Representation: a field element is 8 little-endian 32-bit words, fully
// reduced ([0, p) or [0, n)) after every operation.  One thread owns one
// signature, so every value below lives in that thread's registers.
//
// * mod p: schoolbook 8x8-word product in 64-bit accumulators, then the
//   pseudo-Mersenne fold 2^256 = 2^32 + 977 (mod p), twice, and one
//   conditional subtract.
// * mod n: Montgomery multiplication (CIOS, R = 2^256); only the s^-1
//   chain of the prep kernel uses it, entering and leaving the Montgomery
//   domain once.
// * points: homogeneous projective (X:Y:Z), infinity (0:1:0), with the
//   Renes-Costello-Batina complete formulas for a = 0 (b3 = 21), in the
//   same operation order as the plain PyTorch engine, so every output is
//   the same residue.
//
// Every function is __host__ __device__ so that the arithmetic can also be
// compiled by a host C++ compiler and checked against the exact-int
// oracle without a card.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif
#ifdef __CUDA_ARCH__
#define LDG(p) __ldg(p)  // device pass: the read-only data cache
#else
#define LDG(p) (*(p))
#endif

#define SECP_B3 21u

// ---------------------------------------------------------------------------
// Constants (little-endian words)

HD void fe_set_p(uint32_t r[8]) {
    r[0] = 0xFFFFFC2Fu; r[1] = 0xFFFFFFFEu;
    for (int i = 2; i < 8; i++) r[i] = 0xFFFFFFFFu;
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

#define SECP_N0INV 0x5588B13Fu  // -n^-1 mod 2^32

HD void fe_set_small(uint32_t r[8], uint32_t v) {
    r[0] = v;
    for (int i = 1; i < 8; i++) r[i] = 0;
}

HD void fe_copy(uint32_t r[8], const uint32_t a[8]) {
    for (int i = 0; i < 8; i++) r[i] = a[i];
}

HD bool fe_is_zero(const uint32_t a[8]) {
    uint32_t acc = 0;
    for (int i = 0; i < 8; i++) acc |= a[i];
    return acc == 0;
}

// a >= m
HD bool fe_geq(const uint32_t a[8], const uint32_t m[8]) {
    for (int i = 7; i >= 0; i--) {
        if (a[i] != m[i]) return a[i] > m[i];
    }
    return true;
}

// r = a + b, returns the carry out
HD uint32_t fe_add_raw(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a[i] + b[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    return (uint32_t)c;
}

// r = a - b, returns 1 on borrow
HD uint32_t fe_sub_raw(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint64_t bw = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t d = (uint64_t)a[i] - b[i] - bw;
        r[i] = (uint32_t)d;
        bw = (d >> 32) & 1;
    }
    return (uint32_t)bw;
}

// r = a mod m for any 256-bit a (a < 2^256 < 2m)
HD void fe_reduce_once(uint32_t r[8], const uint32_t a[8], const uint32_t m[8]) {
    fe_copy(r, a);
    if (fe_geq(r, m)) fe_sub_raw(r, r, m);
}

// ---------------------------------------------------------------------------
// Arithmetic mod p

HD void fp_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t p[8];
    fe_set_p(p);
    uint32_t c = fe_add_raw(r, a, b);
    if (c || fe_geq(r, p)) fe_sub_raw(r, r, p);
}

HD void fp_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t p[8];
    fe_set_p(p);
    if (fe_sub_raw(r, a, b)) fe_add_raw(r, r, p);
}

// r = (t + h * 2^256) mod p for h < 2^40, using 2^256 = 2^32 + 977.
HD void fp_fold(uint32_t r[8], const uint32_t t[8], uint64_t h) {
    uint64_t lo = h * 977u;                 // < 2^50
    uint64_t acc = (uint64_t)t[0] + (uint32_t)lo;
    r[0] = (uint32_t)acc;
    acc = (acc >> 32) + t[1] + (lo >> 32) + (uint32_t)h;
    r[1] = (uint32_t)acc;
    acc = (acc >> 32) + t[2] + (h >> 32);
    r[2] = (uint32_t)acc;
#pragma unroll
    for (int i = 3; i < 8; i++) {
        acc = (acc >> 32) + t[i];
        r[i] = (uint32_t)acc;
    }
    if (acc >> 32) {
        // wrapped past 2^256: what is left is < 2^74, add 2^32 + 977 once
        acc = (uint64_t)r[0] + 977u;
        r[0] = (uint32_t)acc;
        acc = (acc >> 32) + r[1] + 1u;
        r[1] = (uint32_t)acc;
#pragma unroll
        for (int i = 2; i < 8; i++) {
            acc = (acc >> 32) + r[i];
            r[i] = (uint32_t)acc;
        }
    }
    uint32_t p[8];
    fe_set_p(p);
    if (fe_geq(r, p)) fe_sub_raw(r, r, p);
}

HD void fp_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)a[i] * b[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    // t = L + H * 2^256 = L + H * 977 + (H << 32)  (mod p)
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)t[8 + i] * 977u + t[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    uint64_t top = c;                       // < 2^10
    c = 0;
#pragma unroll
    for (int i = 1; i < 8; i++) {
        c += (uint64_t)s[i] + t[8 + i - 1];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    top += c + t[15];                       // < 2^33
    fp_fold(r, s, top);
}

HD void fp_sqr(uint32_t r[8], const uint32_t a[8]) { fp_mul(r, a, a); }

HD void fp_mul_small(uint32_t r[8], const uint32_t a[8], uint32_t k) {
    uint32_t s[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a[i] * k;
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    fp_fold(r, s, c);
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

// ---------------------------------------------------------------------------
// Arithmetic mod n (Montgomery, R = 2^256); inputs < n

HD void fn_mont_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t n[8];
    fe_set_n(n);
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)a[j] * b[i] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (uint32_t)c;
        t[9] = (uint32_t)(c >> 32);
        uint32_t m = t[0] * SECP_N0INV;
        c = (uint64_t)m * n[0] + t[0];
        c >>= 32;
#pragma unroll
        for (int j = 1; j < 8; j++) {
            c += (uint64_t)m * n[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    // t < 2n
    if (t[8] || fe_geq(t, n)) fe_sub_raw(t, t, n);
    fe_copy(r, t);
}

HD void fn_mont_sqr_n(uint32_t r[8], const uint32_t a[8], int k) {
    fe_copy(r, a);
#pragma unroll 1
    for (int i = 0; i < k; i++) fn_mont_mul(r, r, r);
}

// a^(n-2) mod n (Fermat; 0 maps to 0) for any 256-bit a.  The chain is
// the plain engine's: a repunit ladder to a^(2^127 - 1), then a scan of
// the low 129 bits of n - 2.
HD void fn_inv(uint32_t out[8], const uint32_t a_in[8]) {
    uint32_t n[8], r2n[8], x[8], t[8];
    fe_set_n(n);
    fe_set_r2n(r2n);
    fe_reduce_once(t, a_in, n);
    fn_mont_mul(x, t, r2n);                          // x = a*R
    uint32_t r2[8], r3[8], r6[8], r7[8], acc[8];
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
        fn_mont_mul(acc, acc, acc);
        uint32_t bit = i == 128 ? 0u : (low[i >> 5] >> (i & 31)) & 1u;
        if (bit) fn_mont_mul(acc, acc, x);
    }
    uint32_t one[8];
    fe_set_small(one, 1);
    fn_mont_mul(out, acc, one);                      // leave the domain
}

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

// K1: y = sqrt(x^3 + 7), d = y^2 - (x^3 + 7), w = s^-1 mod n.
HD void verify_prep_one(const uint32_t qx[8], const uint32_t s[8],
                        uint32_t y[8], uint32_t d[8], uint32_t w[8]) {
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
    fn_inv(w, s);
}

// K2: tables of one key.  Entry (c, v, k) of the (6, 16, 8) table block
// is at out[((c * 16 + v) * 8 + k) * stride]; c = 0..2 are lo X, Y, Z,
// c = 3..5 hi X, Y, Z.  lo[v] = v * (bx, byl, 1); hi[v] = (beta * X_v,
// +-Y_v, Z_v) with Y negated where sflip is set; entry 0 = (0:1:0).
HD void tab_store(uint32_t *out, long long stride, int c, int v,
                  const uint32_t a[8]) {
    fe_store(out + (long long)((c * 16 + v) * 8) * stride, stride, a);
}

HD void build_tables_one(const uint32_t bx[8], const uint32_t byl[8],
                         uint32_t sflip, uint32_t *out, long long stride) {
    uint32_t p[8], beta[8], t[8];
    fe_set_p(p);
    fe_set_beta(beta);
    pt base, acc, inf;
    fe_reduce_once(base.x, bx, p);
    fe_reduce_once(base.y, byl, p);
    fe_set_small(base.z, 1);
    pt_set_inf(inf);
    for (int c = 0; c < 2; c++) {
        tab_store(out, stride, 3 * c + 0, 0, inf.x);
        tab_store(out, stride, 3 * c + 1, 0, inf.y);
        tab_store(out, stride, 3 * c + 2, 0, inf.z);
    }
    acc = base;
#pragma unroll 1
    for (int v = 1; v < 16; v++) {
        if (v > 1) pt_add(acc, acc, base);
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

HD void tab_load(pt &o, const uint32_t *tab, long long stride, int half,
                 int v) {
    const long long plane = (long long)16 * 8 * stride;   // one coordinate
    const uint32_t *b = tab + (long long)((3 * half * 16 + v) * 8) * stride;
    fe_load(o.x, b, stride);
    fe_load(o.y, b + plane, stride);
    fe_load(o.z, b + 2 * plane, stride);
}

// The joint fixed-base table: entry g holds X, Y, Z as 3 x 8 words.
HD void joint_load(pt &o, const uint32_t *jt, int g) {
    const uint32_t *b = jt + g * 24;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        o.x[k] = LDG(b + k);
        o.y[k] = LDG(b + 8 + k);
        o.z[k] = LDG(b + 16 + k);
    }
}

#define GLV_WINDOWS 33

// K3: the 33-window GLV scan, acc = 16 acc + Qlo[d2l] + Qhi[d2h] + G[g],
// from infinity.  Digits and joint indices are (33, B) planes, MSB first.
HD void glv_scan_one(const int32_t *d2l, const int32_t *d2h,
                     const int32_t *gidx, long long stride,
                     const uint32_t *tab, const uint32_t *jt, pt &acc) {
    pt q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < GLV_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        tab_load(q, tab, stride, 0, d2l[w * stride] & 15);
        pt_add(acc, acc, q);
        tab_load(q, tab, stride, 1, d2h[w * stride] & 15);
        pt_add(acc, acc, q);
        joint_load(q, jt, gidx[w * stride] & 1023);
        pt_add(acc, acc, q);
    }
}

// Word planes, the points K4-K6 take: entry j of an (n, 3, 8, B) plane
// tensor (entry, coordinate, word, signature); callers pass base offset
// by the signature.
HD void plane_load(pt &o, const uint32_t *planes, long long stride, int j) {
    const uint32_t *b = planes + (long long)j * 24 * stride;
    fe_load(o.x, b, stride);
    fe_load(o.y, b + 8 * stride, stride);
    fe_load(o.z, b + 16 * stride, stride);
}

// K4: the 33-window GLV scan with separate fixed-base additions,
// acc = 16 acc + Qlo[d2l] + Qhi[d2h] + G1[w] + G2[w], from infinity.
// Digits are (33, B) planes, MSB first; g1, g2 the pre-selected,
// pre-signed G and phi(G) points as (33, 3, 8, B) planes.
HD void glv_scan2_one(const int32_t *d2l, const int32_t *d2h,
                      long long stride, const uint32_t *tab,
                      const uint32_t *g1, const uint32_t *g2, pt &acc) {
    pt q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < GLV_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        tab_load(q, tab, stride, 0, d2l[w * stride] & 15);
        pt_add(acc, acc, q);
        tab_load(q, tab, stride, 1, d2h[w * stride] & 15);
        pt_add(acc, acc, q);
        plane_load(q, g1, stride, w);
        pt_add(acc, acc, q);
        plane_load(q, g2, stride, w);
        pt_add(acc, acc, q);
    }
}

#define DUAL_WINDOWS 64

// K5: the 64-window scan without GLV, acc = 16 acc + Qtab[d2] + G[w],
// from infinity.  d2 is a (64, B) digit plane, MSB first; qtab the
// per-key table v*Q as (16, 3, 8, B) planes, selected here; gs the
// pre-selected G points as (64, 3, 8, B) planes.
HD void dual_mul_v2_one(const int32_t *d2, long long stride,
                        const uint32_t *qtab, const uint32_t *gs, pt &acc) {
    pt q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < DUAL_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        plane_load(q, qtab, stride, d2[w * stride] & 15);
        pt_add(acc, acc, q);
        plane_load(q, gs, stride, w);
        pt_add(acc, acc, q);
    }
}

// K6: the 64-window scan over pre-selected points,
// acc = 16 acc + Q[w] + G[w], from infinity; qs, gs are (64, 3, 8, B).
HD void dual_mul_planes_one(const uint32_t *qs, const uint32_t *gs,
                            long long stride, pt &acc) {
    pt q;
    pt_set_inf(acc);
#pragma unroll 1
    for (int w = 0; w < DUAL_WINDOWS; w++) {
#pragma unroll 1
        for (int k = 0; k < 4; k++) pt_double(acc, acc);
        plane_load(q, qs, stride, w);
        pt_add(acc, acc, q);
        plane_load(q, gs, stride, w);
        pt_add(acc, acc, q);
    }
}
