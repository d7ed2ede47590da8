// Device helpers shared by the port's CUDA sources (fused_dehaze.cu,
// staged.cu): wire-dtype loads and stores, the clipped-window count, the
// order-preserving (t, flat index) key with its warp and block minima, the
// top-1 tile-key helpers (a tile's smallest key, a frame's smallest tile
// key), which the staged atmospheric light (B6a) and the megakernel's
// tiled top-1 path (B1) share, the tiled window passes' helpers (cp.async
// copies and register-blocked window runs), which B1's tiled passes and the
// staged dark channel and box filter (B3a, B4) share, and the two top-k
// kernels built on the key (per-tile key lists, then a per-frame merge),
// which the megakernel's candidate passes (B1, B7) and the staged top-k
// atmospheric light (B6b) all launch, and Eq. 9's step, which the
// megakernel's EMA (B1) and the staged state sync (st_merge_ema) share.
// Each source is built into a library of its own, so every helper lives
// in this header's own namespace and is compiled once per library.

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
// Tiled window passes: the helpers that the megakernel's tiled passes (B1)
// and the staged window strips (B3a, B4) share. A block copies its inputs
// with their window halo into shared memory with cp.async, then takes the
// windows from there in register-blocked runs.
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;                 // opt-in shared memory a block

// Register-blocked window run: acc[q][j] (planes q < NP, outputs j < R) =
// op over i = 0 .. w of v_q(j + i), taken in ascending i, where fetch(k, v)
// loads v_q(k) of every plane. Each input is fetched once for R outputs
// (R + w loads, not R * (w + 1)). op is __fadd_rn from +0 (kSum) or fminf
// from +inf; w = 2r >= 0 is a runtime value. Where w >= R - 1 the run is a
// ramp up, a loop in which every output takes the input, and a ramp down,
// all without a test; narrower windows take the tested loop.
template <int NP, int R, bool kSum, class Fetch>
__device__ __forceinline__ void window_run(const Fetch& fetch, int w, float (&acc)[NP][R]) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[q][j] = kSum ? 0.0f : INFINITY;
    float v[NP];
    if (w >= R - 1) {
#pragma unroll
        for (int k = 0; k < R - 1; ++k) {        // outputs j <= k
            fetch(k, v);
#pragma unroll
            for (int j = 0; j <= k; ++j)
#pragma unroll
                for (int q = 0; q < NP; ++q)
                    acc[q][j] = kSum ? __fadd_rn(acc[q][j], v[q]) : fminf(acc[q][j], v[q]);
        }
        for (int k = R - 1; k <= w; ++k) {       // every output
            fetch(k, v);
#pragma unroll
            for (int j = 0; j < R; ++j)
#pragma unroll
                for (int q = 0; q < NP; ++q)
                    acc[q][j] = kSum ? __fadd_rn(acc[q][j], v[q]) : fminf(acc[q][j], v[q]);
        }
#pragma unroll
        for (int t = 1; t < R; ++t) {            // outputs j >= t
            fetch(w + t, v);
#pragma unroll
            for (int j = t; j < R; ++j)
#pragma unroll
                for (int q = 0; q < NP; ++q)
                    acc[q][j] = kSum ? __fadd_rn(acc[q][j], v[q]) : fminf(acc[q][j], v[q]);
        }
    } else {
        for (int k = 0; k < R + w; ++k) {
            fetch(k, v);
#pragma unroll
            for (int j = 0; j < R; ++j)
                if (static_cast<unsigned>(k - j) <= static_cast<unsigned>(w)) {
#pragma unroll
                    for (int q = 0; q < NP; ++q)
                        acc[q][j] = kSum ? __fadd_rn(acc[q][j], v[q])
                                         : fminf(acc[q][j], v[q]);
                }
        }
    }
}

// Asynchronous copies global -> shared (cp.async): each thread keeps many
// in flight, without registers; src_bytes < the copy's size zero-fills the
// rest (0 reads nothing). cp_async_wait waits for the calling thread's.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies in groups: cp_async_commit closes the calling thread's group of
// copies started since the last; cp_async_wait_group<n> waits until at
// most its n newest groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Top-1 tile keys. A frame is cut into tiles (contiguous runs of pixels for
// B6a, 2-D tiles for B1); each tile's block writes its smallest key with
// block_min_u64, and a second launch takes each frame's smallest tile key
// with warp_min_keys. The key holds the flat index, so the minimum over the
// tile keys is the frame's smallest (t, index) key whatever the tiles'
// shape or order: ties across tiles go to the lowest index, not to the
// first tile.
// ---------------------------------------------------------------------------

// The smallest of keys[0..n) (kNoKey for n = 0), in every lane of the
// calling warp, which must be whole.
__device__ __forceinline__ unsigned long long warp_min_keys(
        const unsigned long long* __restrict__ keys, int n) {
    unsigned long long best = kNoKey;
    for (int j = threadIdx.x & 31; j < n; j += 32) {
        const unsigned long long v = keys[j];
        best = v < best ? v : best;
    }
    return __shfl_sync(0xffffffffu, warp_min_u64(best), 0);
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

// One step of Eq. 9 (exactly kernels/ref.py::ema_step's semantics, the
// reference's _ema_step) for frame id fid with candidate cand[0..3):
// updates the lane's A, last update k and inited; a_out[0..3) = A after the
// step. lam and one_minus_lam are float32(lam) and float32(1 - lam), the
// latter taken in double, as PyTorch rounds a scalar operand. The
// megakernel's select_ema, the ten passes' ema pass and the staged state
// sync (staged.cu, st_merge_ema) all run this copy.
__device__ __forceinline__ void ema_step(float (&A)[3], int& k, int& inited,
                                         const float* __restrict__ cand, int fid,
                                         float* __restrict__ a_out, int period, float lam,
                                         float one_minus_lam) {
    const bool valid = fid >= 0;
    const bool bootstrap = valid && inited == 0;
    // int32 difference wraps, as in the reference.
    const int gap = static_cast<int>(static_cast<unsigned>(fid) - static_cast<unsigned>(k));
    const bool upd = valid && (bootstrap || gap >= period);
    for (int c = 0; c < 3; ++c) {
        const float cv = cand[c];
        const float target = bootstrap ? cv
            : __fadd_rn(__fmul_rn(lam, cv), __fmul_rn(one_minus_lam, A[c]));
        if (upd) A[c] = target;
        a_out[c] = A[c];
    }
    if (upd) k = fid;
    inited = max(inited, valid ? 1 : 0);
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

// The rgb of picked pixels summed with Neumaier compensation, in the order
// added; mean() is the sum over k picks.
struct RgbSum {
    float s[3] = {0.0f, 0.0f, 0.0f};
    float c[3] = {0.0f, 0.0f, 0.0f};

    // img (img_dt, uint8 times u8_scale) at element px3 = 3 * pixel.
    __device__ __forceinline__ void add(const void* __restrict__ img, long long px3,
                                        int img_dt, float u8_scale) {
        for (int q = 0; q < 3; ++q) comp_add(s[q], c[q], load_px(img, px3 + q, img_dt, u8_scale));
    }

    __device__ __forceinline__ float mean(int q, int k) const {
        return __fdiv_rn(__fadd_rn(s[q], c[q]), static_cast<float>(k));
    }
};

// Block-wide merge of one frame's n_lists ascending lists of kk keys into
// its k smallest keys (1 <= k <= P), k rounds of a block-wide minimum over
// the list heads. On thread 0: sum holds the rgb of img (frame_px = the
// frame's first pixel) over the picks in ascending order, first the
// smallest key. head holds n_lists ints. At k = 1 the lists may be the
// single keys of any tiling (the one round needs no list number).
template <int kThreads>
__device__ void merge_heads(const unsigned long long* __restrict__ lists, int n_lists,
                            int kk, int k, const void* __restrict__ img, int img_dt,
                            float u8_scale, long long frame_px, int* head,
                            unsigned long long* red, RgbSum& sum,
                            unsigned long long& first) {
    for (int j = threadIdx.x; j < n_lists; j += kThreads) head[j] = 0;
    __syncthreads();
    for (int s = 0; s < k; ++s) {
        unsigned long long best = kNoKey;
        for (int j = threadIdx.x; j < n_lists; j += kThreads) {
            const int h = head[j];
            if (h < kk) {
                const unsigned long long v = lists[static_cast<long long>(j) * kk + h];
                best = v < best ? v : best;
            }
        }
        const unsigned long long m = block_min_u64<kThreads>(best, red);
        if (threadIdx.x == 0) {
            // Every list holds its tile's smallest keys, so the k smallest
            // of the frame are all there and m is a real key.
            const unsigned idx = static_cast<unsigned>(m & 0xffffffffULL);
            if (s + 1 < k) ++head[idx / kTopkTile];   // list j is tile j
            sum.add(img, 3 * (frame_px + static_cast<long long>(idx)), img_dt, u8_scale);
            if (s == 0) first = m;
        }
        __syncthreads();                         // head[] read after the update
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
    RgbSum sum;
    unsigned long long first = kNoKey;
    merge_heads<kTopkThreads>(keys + n * static_cast<long long>(n_lists) * kk, n_lists,
                              kk, k, img, img_dt, u8_scale, n * P, head, red, sum, first);
    if (threadIdx.x == 0) {
        for (int q = 0; q < 3; ++q) store_px(out, 3 * n + q, out_dt, sum.mean(q, k));
        if (t_min != nullptr) t_min[n] = key_to_t(first);
    }
}

}  // namespace dehaze
