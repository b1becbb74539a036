// Device-side helpers of the routing kernels (route_sweep.cu, mcf_ssp.cu),
// which run a query on a thread block cluster and split its nodes by
// range across the cluster's blocks: node v belongs to block v >> shift
// (per = 1 << shift nodes a block), which keeps v's entries at index
// v & (per - 1) of its arrays, in its shared memory (the other blocks
// reach them through distributed shared memory) or in global memory
// (read with ld.global.cg, past the SM's L1, since other SMs of the
// cluster write them between barriers).
#pragma once
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// A block's shared variable as block r of the cluster holds it.
template <class T>
__device__ __forceinline__ T *sh_of(T *p, int r) {
    return cg::this_cluster().map_shared_rank(p, r);
}

template <class T>
__device__ __forceinline__ T vld(const T *p) {
    return *(const volatile T *)p;
}

__device__ __forceinline__ int64_t ld_cg(const int64_t *p) {
    return (int64_t)__ldcg((const long long *)p);
}
__device__ __forceinline__ int32_t ld_cg(const int32_t *p) {
    return __ldcg((const int *)p);
}
__device__ __forceinline__ double ld_cg(const double *p) {
    return __ldcg(p);
}
__device__ __forceinline__ uint64_t ld_cg(const uint64_t *p) {
    return (uint64_t)__ldcg((const unsigned long long *)p);
}

// A 64-bit atomic minimum that holds on another block's shared memory:
// a compare-and-swap loop.  On the H100 a 64-bit atomicMin there is not
// atomic (lanes folding into one word all read its initial value, and
// the minimum comes out wrong), where atomicCAS and the 32-bit
// atomicMin are; lightning_tpu_torch/routing_ablation.py DSM_MIN_PROBE
// shows it.  Returns the entry before the update, or the entry it found
// if v does not lower it.
template <class T>
__device__ __forceinline__ T cas_min(T *p, T v) {
    unsigned long long *q = (unsigned long long *)p;
    T old = vld(p);
    while (v < old) {
        const T prev = (T)atomicCAS(q, (unsigned long long)old,
                                    (unsigned long long)v);
        if (prev == old) break;
        old = prev;
    }
    return old;
}

// Where a node's entries live: in this block's shared memory (DSM) or in
// the query's global scratch, a block's own range at `seg` pointers;
// of_rank and at give pointers to any block's entries.
template <bool DSM>
struct node_view {
    int rank, per, shift;

    template <class T>
    __device__ __forceinline__ T *of_rank(T *seg, int r) const {
        if (DSM) return sh_of(seg, r);
        return seg + (ptrdiff_t)(r - rank) * per;
    }
    template <class T>
    __device__ __forceinline__ T *at(T *seg, int v) const {
        return of_rank(seg, v >> shift) + (v & (per - 1));
    }
    template <class T>
    __device__ __forceinline__ T ld(const T *p) const {
        if (DSM) return vld(p);
        return ld_cg(p);
    }
    // atomic minimum; returns the entry before it
    __device__ __forceinline__ int64_t amin(int64_t *p, int64_t v) const {
        if (DSM) return cas_min(p, v);
        return (int64_t)atomicMin((long long *)p, (long long)v);
    }
    __device__ __forceinline__ uint64_t amin(uint64_t *p,
                                             uint64_t v) const {
        if (DSM) return cas_min(p, v);
        return (uint64_t)atomicMin((unsigned long long *)p,
                                   (unsigned long long)v);
    }
    __device__ __forceinline__ int32_t amin(int32_t *p, int32_t v) const {
        return atomicMin(p, v);
    }
};
