// The routing kernels' per-element arithmetic, __host__ __device__ so the
// host compiler can build it and the CPU tests hold it against the plain
// PyTorch versions (tests/test_torch_csrc_route_host.py):
//
// * R1 (route_sweep.cu): one directed edge's price for one query, the
//   exact int64 cost model of lightning_tpu/routing/device.py
//   _make_single (:160-178): the overflow guard a > min(2^61 // max(ppm,
//   1), 2^61 // max(cd * rf, 1)), decided without a division
//   (rt_unsafe), the HTLC window on the amount the receiving node gets,
//   and cand = d_v + base + a_v * ppm // 10^6 + 1 + a_v * cd * rf //
//   5259600 (divisions by constants, which the compiler turns into
//   multiply-high sequences);
// * R2 (mcf_ssp.cu): the order-preserving unsigned 64-bit key of a
//   double, so a float64 minimum can be an integer atomicMin.  -0.0 keys
//   as +0.0 (reverse arcs carry -cost, so -0.0 occurs); equal doubles
//   then have equal keys and a smaller double a smaller key.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

#define RT_INF_COST (1LL << 62)           // label sentinel (device.py:89)
#define RT_OVF_LIMIT (1LL << 61)          // per-edge product bound (:91)
#define RT_RISK_DENOM (52596LL * 100)     // BLOCKS_PER_YEAR * 100
#define RT_I64_MAX 0x7fffffffffffffffLL
#define RT_I32_MAX 0x7fffffff

// The amount past which an edge's products could leave int64 headroom,
// in the reference's division form (the kernel uses rt_unsafe).
RT_HD int64_t rt_threshold(int64_t ppm, int64_t cdr) {
    int64_t a = RT_OVF_LIMIT / (ppm > 1 ? ppm : 1);
    int64_t b = RT_OVF_LIMIT / (cdr > 1 ? cdr : 1);
    return a < b ? a : b;
}

// a > 2^61 // p for p >= 1, as a * p > 2^61 on the 128-bit product: for
// integers a >= 0, a > floor(L / p) exactly when a >= floor(L / p) + 1,
// which holds exactly when a * p > L.  a <= 0 never passes.
RT_HD int rt_over(int64_t a, int64_t p) {
    if (a <= 0) return 0;
    const uint64_t x = (uint64_t)a, y = (uint64_t)p;
#ifdef __CUDA_ARCH__
    const uint64_t hi = __umul64hi(x, y);
#else
    const uint64_t hi = (uint64_t)(((unsigned __int128)x * y) >> 64);
#endif
    return hi != 0 || x * y > (uint64_t)RT_OVF_LIMIT;
}

// a > rt_threshold(ppm, cdr), with no division.
RT_HD int rt_unsafe(int64_t a, int64_t ppm, int64_t cdr) {
    return rt_over(a, ppm > 1 ? ppm : 1) || rt_over(a, cdr > 1 ? cdr : 1);
}

// One edge u -> v for one query.  d_v, a_v: the receiving node's
// previous-sweep cost and amount; cdr = cd * rf.  Returns 1 when the edge
// relaxes (then *cand is its candidate cost for u and *fee its fee), 0
// otherwise; sets *ovf when the edge passes every test but the overflow
// guard (device.py:169-175).
RT_HD int rt_price(int64_t d_v, int64_t a_v, int enabled, int64_t base,
                   int64_t ppm, int64_t hmin, int64_t hmax, int64_t cdr,
                   int64_t *cand, int64_t *fee, int *ovf) {
    int ok = enabled && d_v < RT_INF_COST && a_v >= hmin
             && (hmax == 0 || a_v <= hmax);
    if (!ok) return 0;
    if (rt_unsafe(a_v, ppm, cdr)) {
        *ovf = 1;
        return 0;
    }
    *fee = base + (a_v * ppm) / 1000000;
    *cand = d_v + *fee + 1 + (a_v * cdr) / RT_RISK_DENOM;
    return 1;
}

RT_HD uint64_t rt_bits(double d) {
#ifdef __CUDA_ARCH__
    return (uint64_t)__double_as_longlong(d);
#else
    uint64_t u;
    memcpy(&u, &d, sizeof u);
    return u;
#endif
}

RT_HD double rt_double(uint64_t u) {
#ifdef __CUDA_ARCH__
    return __longlong_as_double((long long)u);
#else
    double d;
    memcpy(&d, &u, sizeof d);
    return d;
#endif
}

// Order-preserving key of a non-NaN double (-0.0 as +0.0).
RT_HD uint64_t mcf_key(double d) {
    uint64_t u = rt_bits(d == 0.0 ? 0.0 : d);
    return (u >> 63) ? ~u : (u | 0x8000000000000000ULL);
}

// The double of a key (the inverse of mcf_key but for the sign of zero).
RT_HD double mcf_unkey(uint64_t k) {
    return rt_double((k >> 63) ? (k & 0x7fffffffffffffffULL) : ~k);
}
