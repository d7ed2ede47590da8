// Device helpers shared by the port's CUDA sources (fused_dehaze.cu,
// staged.cu): wire-dtype loads and stores, the clipped-window count, the
// order-preserving (t, flat index) key with its warp and block minima, and
// the two top-k kernels built on it (per-tile key lists, then a per-frame
// merge), which the megakernel's candidate passes (B1, B7) and the staged
// top-k atmospheric light (B6b) all launch. Each source is built into a
// library of its own, so every helper lives in this header's own namespace
// and is compiled once per library.

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

// t of a key (inverse of make_key; -0.0 comes back as +0.0).
__device__ __forceinline__ float key_to_t(unsigned long long key) {
    unsigned u = static_cast<unsigned>(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
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

// ---------------------------------------------------------------------------
// The k smallest keys of a frame: per-tile lists, then a merge.
//
// The TPU kernels fold row tiles through their sequential grid
// (atmolight.py::topk_select); CUDA blocks run in no order, so the top-k is
// two launches. topk_block_kernel: one block a tile of kTopkTile pixels
// (grid tiles x frames, so the SMs fill even at a few frames) keeps the
// tile's kk = min(k, kTopkTile) smallest keys in ascending order, kk rounds
// of a block-wide minimum over eight keys a thread. topk_merge_kernel: one
// block a frame merges the frame's ascending tile lists, k rounds of a
// block-wide minimum over the list heads, so a round costs the same for any
// k, up to k = H*W. The picks come out in ascending (t, index) order and
// their RGB is summed in that order with a compensated (Neumaier) float32
// sum, so the mean stays within a few float32 steps of the exact mean for
// any k. The plain versions gather the same picks and take their mean in
// float64, rounded once to float32.
// ---------------------------------------------------------------------------

constexpr int kTopkThreads = 256;
constexpr int kTopkItems = 8;                        // pixels a thread
constexpr int kTopkTile = kTopkThreads * kTopkItems; // pixels a tile (block)
constexpr int kTopkMaxLists = 8192;                  // tiles a frame the merge takes

// Neumaier's compensated sum: s + c is the sum of the terms added so far
// with an error of about one float32 step of it, however many there are.
__device__ __forceinline__ void comp_add(float& s, float& c, float x) {
    const float t = __fadd_rn(s, x);
    const float lost = fabsf(s) >= fabsf(x) ? __fadd_rn(__fsub_rn(s, t), x)
                                            : __fadd_rn(__fsub_rn(x, t), s);
    c = __fadd_rn(c, lost);
    s = t;
}

// Keys a tile keeps: a tile holds no more than kTopkTile pixels.
__host__ __device__ __forceinline__ int tile_keep(int k) {
    return k < kTopkTile ? k : kTopkTile;
}

// grid (n_tiles, N): block (j, n) writes the kk smallest keys of pixels
// [j*kTopkTile, (j+1)*kTopkTile) of frame n of t (P pixels a frame, t_dt),
// ascending, kNoKey where the tile has fewer than kk pixels.
__global__ void topk_block_kernel(const void* __restrict__ t, int t_dt,
                                  unsigned long long* __restrict__ keys,
                                  long long P, int kk) {
    __shared__ unsigned long long red[kTopkThreads / 32 + 1];
    const long long n = blockIdx.y;
    const long long base = static_cast<long long>(blockIdx.x) * kTopkTile;
    unsigned long long mine[kTopkItems];
#pragma unroll
    for (int j = 0; j < kTopkItems; ++j) {
        const long long idx = base + j * kTopkThreads + threadIdx.x;
        mine[j] = idx < P ? make_key(load_px(t, n * P + idx, t_dt, 1.0f),
                                     static_cast<unsigned>(idx))
                          : kNoKey;
    }
    unsigned long long* out = keys + (n * gridDim.x + blockIdx.x) * kk;
    for (int s = 0; s < kk; ++s) {
        unsigned long long best = kNoKey;
#pragma unroll
        for (int j = 0; j < kTopkItems; ++j) best = mine[j] < best ? mine[j] : best;
        const unsigned long long m = block_min_u64<kTopkThreads>(best, red);
        // Keys are unique (the low word is the index): one owner retires it.
#pragma unroll
        for (int j = 0; j < kTopkItems; ++j)
            if (mine[j] == m) mine[j] = kNoKey;
        if (threadIdx.x == 0) out[s] = m;
    }
}

// grid (N,): merge frame n's n_lists ascending lists of kk keys into its k
// smallest keys (1 <= k <= P). out[n] (3 values, out_dt) = the mean of img
// (img_dt, uint8 times u8_scale) over those pixels; t_min[n], where given,
// = the t of the smallest key.
__global__ void topk_merge_kernel(const unsigned long long* __restrict__ keys,
                                  int n_lists, int kk, int k,
                                  const void* __restrict__ img, int img_dt,
                                  float u8_scale, long long P,
                                  void* __restrict__ out, int out_dt,
                                  float* __restrict__ t_min) {
    __shared__ unsigned long long red[kTopkThreads / 32 + 1];
    __shared__ int head[kTopkMaxLists];          // next unread key of each list
    const long long n = blockIdx.x;
    const unsigned long long* lists = keys + n * static_cast<long long>(n_lists) * kk;
    for (int j = threadIdx.x; j < n_lists; j += kTopkThreads) head[j] = 0;
    __syncthreads();
    float sr = 0.0f, sg = 0.0f, sb = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    for (int s = 0; s < k; ++s) {
        unsigned long long best = kNoKey;
        for (int j = threadIdx.x; j < n_lists; j += kTopkThreads) {
            const int h = head[j];
            if (h < kk) {
                const unsigned long long v = lists[static_cast<long long>(j) * kk + h];
                best = v < best ? v : best;
            }
        }
        const unsigned long long m = block_min_u64<kTopkThreads>(best, red);
        if (threadIdx.x == 0) {
            // Every list holds its tile's smallest keys, so the k smallest
            // of the frame are all there and m is a real key.
            const unsigned idx = static_cast<unsigned>(m & 0xffffffffULL);
            ++head[idx / kTopkTile];             // list j is tile j
            const long long px = 3 * (n * P + static_cast<long long>(idx));
            comp_add(sr, cr, load_px(img, px, img_dt, u8_scale));
            comp_add(sg, cg, load_px(img, px + 1, img_dt, u8_scale));
            comp_add(sb, cb, load_px(img, px + 2, img_dt, u8_scale));
            if (s == 0 && t_min != nullptr) t_min[n] = key_to_t(m);
        }
        __syncthreads();                         // head[] read after the update
    }
    if (threadIdx.x == 0) {
        const float kf = static_cast<float>(k);
        store_px(out, 3 * n, out_dt, __fdiv_rn(__fadd_rn(sr, cr), kf));
        store_px(out, 3 * n + 1, out_dt, __fdiv_rn(__fadd_rn(sg, cg), kf));
        store_px(out, 3 * n + 2, out_dt, __fdiv_rn(__fadd_rn(sb, cb), kf));
    }
}

}  // namespace dehaze
