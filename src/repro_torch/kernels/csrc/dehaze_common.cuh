// Device helpers shared by the port's CUDA sources (fused_dehaze.cu,
// staged.cu): wire-dtype loads and stores, the clipped-window count, and
// the order-preserving (t, flat index) key with its warp and block minima.
// Each source is built into a library of its own, so every helper lives in
// this header's own namespace and is compiled once per library.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace dehaze {

constexpr unsigned long long kNoKey = ~0ULL;

// dt: 0 float32, 1 bfloat16, 2 uint8 (times u8_scale = float32(1/255)).
__device__ __forceinline__ float load_px(const void* p, long long i, int dt,
                                         float u8_scale) {
    if (dt == 0) return static_cast<const float*>(p)[i];
    if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    return __fmul_rn(static_cast<float>(static_cast<const uint8_t*>(p)[i]), u8_scale);
}

// dt: 0 float32, 1 bfloat16 (round to nearest even).
__device__ __forceinline__ void store_px(void* p, long long i, int dt, float v) {
    if (dt == 0) static_cast<float*>(p)[i] = v;
    else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float clip01(float v) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
}

// Closed-form count of in-bounds window elements along one axis.
__device__ __forceinline__ int win_count(int i, int n, int r) {
    return min(i + r, n - 1) - max(i - r, 0) + 1;
}

// Order-preserving key: t's bits in the high word (sign handled: DCP t_raw
// is negative where I/A > 1/omega), flat pixel index in the low word. The
// smallest key is the smallest t, ties to the lowest index.
__device__ __forceinline__ unsigned long long make_key(float t, unsigned idx) {
    if (t == 0.0f) t = 0.0f;                     // -0.0 ties with +0.0
    unsigned u = __float_as_uint(t);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(u) << 32) | idx;
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
    for (int off = 16; off > 0; off >>= 1) {
        unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
        v = o < v ? o : v;
    }
    return v;
}

// Block-wide minimum, broadcast to every thread of a kThreads-thread block;
// red holds kThreads / 32 + 1 keys.
template <int kThreads>
__device__ unsigned long long block_min_u64(unsigned long long v,
                                            unsigned long long* red) {
    static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, <= 1024");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_min_u64(v);
    __syncthreads();                             // red[] free from last call
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < kThreads / 32 ? red[lane] : kNoKey;
        v = warp_min_u64(v);
        if (lane == 0) red[kThreads / 32] = v;
    }
    __syncthreads();
    return red[kThreads / 32];
}

}  // namespace dehaze
