// The staged component kernels for NVIDIA Hopper (sm_90a): the paper's
// three components as separate kernels, the chain that kernel_mode "auto"
// (and "pallas") runs.
//
// Replaces the TPU kernels
//   st_dark_channel     src/repro/kernels/dark_channel.py::dark_channel_pallas
//   st_min_filter       src/repro/kernels/dark_channel.py::min_filter_2d_pallas
//   st_box_filter       src/repro/kernels/boxfilter.py::box_filter_2d_pallas
//   st_atmolight        src/repro/kernels/atmolight.py::atmolight_pallas
//   st_atmolight_topk   src/repro/kernels/atmolight.py::atmolight_topk_pallas
//   st_recover          src/repro/kernels/recover.py::recover_pallas
// and the spatially sharded step's
//   st_masked_min_filter  src/repro/kernels/dark_channel.py::masked_min_filter_2d_pallas
//   st_masked_box_filter  src/repro/kernels/boxfilter.py::masked_box_filter_2d_pallas
//   st_merge_topk         src/repro/kernels/atmolight.py::merge_topk_pallas
// Each computes what its Pallas kernel computes: it reads float32 or
// bfloat16, computes in float32 and writes its Pallas kernel's output dtype.
//
// Windows (dark channel, min filter, box filter). The TPU kernels hold a
// whole frame in
// VMEM; a 480x640 float32 plane is 1.2 MB against at most 227 KB of
// shared memory a block. So a block computes a kTileY x kTileX output tile: each
// thread of a warp owns one output column; first the horizontal window of
// every input row the tile's vertical windows touch (kTileY + 2r rows, at
// most H) goes into shared memory, then the vertical window is taken from
// there. Windows are clipped to the frame (+inf for the min, a closed-form
// count for the mean), so any radius works, also r = 0 and windows wider
// than the frame; shared memory is min(kTileY + 2r, H) * kTileX floats. The
// min is a pure selection and equals its plain version bit for bit. The
// mean is a direct sum over the clipped window divided by the closed-form
// in-bounds count, not the Pallas kernel's cumsum differences: the same
// function, better conditioned for the guided filter's var_g = corr_gg -
// mean_g^2 over var_g + eps.
//
// Atmospheric light (argmin t). The TPU kernel folds row tiles through its
// sequential grid; CUDA blocks run in no order, so the argmin is the
// minimum of a 64-bit key (order-preserving bits of t, flat index): ties go
// to the lowest index, -0.0 ties with +0.0, and the result cannot depend on
// the order in which threads or blocks run. What bounds it is reading t
// once (at 32 frames of 480x640 float32, 39.3 MB: 0.0117 ms at 3.35 TB/s;
// the gather reads 3 values a frame). One block a frame left 100 of the
// H100's 132 SMs idle at 32 frames, so it is two launches from one entry
// point: a grid of (tiles, N) blocks, each reducing a tile of kTop1Tile
// contiguous pixels (16-byte loads, four in flight a thread, where t is
// float32 and the tile whole and aligned; 8-byte loads for bfloat16) to
// its smallest key with block_min_u64 (2400 blocks at 32 frames of
// 480x640, every SM busy), then one warp a frame taking the smallest of its
// tile keys (warp_min_keys, the helper the megakernel's top-1 merge uses)
// and gathering I's RGB there. The caller gives the tile keys' scratch.
//
// Top-k atmospheric light (k > 1). The TPU kernel folds each row tile's
// top-k into k rows carried through its sequential grid. Here the top-k
// kernels of dehaze_common.cuh, which the megakernel's candidate passes
// launch too: per-tile lists of the kk = min(k, 2048) smallest keys, one
// block a tile over all frames, then one block a frame merging the list
// heads, k rounds for any k up to H*W; the mean of I over the k picks is a
// compensated float32 sum in ascending (t, index) order over k, cast to
// the frames' dtype. The caller gives the key lists' scratch (N x tiles x
// kk keys).
//
// Masked windows (the halo-extended planes of a spatial shard). The window
// kernel's two masked forms take an (H,) row and a (W,) column validity
// vector (bytes, 0 = invalid): the min reads an invalid pixel as +inf; the
// mean leaves it out of the sum (a select, not a multiply: an upstream
// +-inf must not become NaN) and divides by max(rowcnt(y) * colcnt(x), 1),
// each count the windowed sum of its axis's mask. The reference's XLA
// filter divides by the windowed sum of the 2-D mask; the masks are outer
// products, so the two are the same integer, and the product is cheaper.
//
// Cross-shard candidate merge (st_merge_topk). After the all-gather each
// frame has M = shards x k candidate rows (t, global flat index, rgb) in
// no promised order. The TPU kernel folds k-row segments through its
// sequential grid. The head merge of dehaze_common.cuh cannot take these
// rows: it finds a key's list as index / kTopkTile and gathers I at the
// pixel index, and a gathered row has neither. So one block a frame ranks
// its rows by the 64-bit key of dehaze_common.cuh built from the given
// global index (sign bit flipped, so negative indices keep their order),
// ties in both to the lower row, as the reference's stable two-key sort;
// the rows of rank < k go to their slot of a k-entry scratch list, and one
// thread sums their rgb in ascending order with the compensated sum of the
// top-k merge. Ranking costs M^2 compares a frame: nothing for M = shards
// x k (16 at four shards and k = 4), and the merge moves 20 bytes a row.
//
// Recovery. One elementwise pass: J = clip((I - A)/max(t, t0) + A, 0, 1),
// then powf only when gamma != 1, with A per frame.
//
// What bounds them on the H100: device-memory bytes (each is a few
// operations per byte). At 32 frames of 480x640 float32 the byte bounds are
// 0.047 ms (dark channel, 16 B/px), 0.023 ms (min and box filter, 8 B/px),
// 0.047 ms (atmospheric light, 16 B/px counting all of I; the top-k's
// reads only t and k pixels a frame, 0.012 ms) and 0.082 ms (recover,
// 28 B/px); the masked filters are bound as the min and box filter (8 B/px
// of the plane they filter), the merge by its 20 bytes a row. The window
// kernels do not reach them: each window tap is a load (2r + 1 per output
// per axis, the dark channel's three channels each time).
//
// Rounding: IEEE division and powf (no fast math, --fmad=false), float32
// constants rounded on the Python side exactly as PyTorch rounds a scalar
// operand. Every entry point launches on the caller's stream, allocates
// nothing and returns the cudaError_t of its launch (0 on success).

#include "dehaze_common.cuh"

namespace {

using namespace dehaze;

constexpr int kTileX = 32;                       // output columns a block (one warp)
constexpr int kTileY = 64;                       // output rows a block
constexpr int kRowThreads = 8;                   // warps a window block
constexpr int kReduceThreads = 1024;             // threads of a merge_topk block
constexpr int kMaxSmem = 232448;                 // opt-in shared memory a block
constexpr int kTop1Threads = 256;                // threads of an atmolight tile block
constexpr int kTop1Items = 16;                   // pixels a thread
constexpr int kTop1Tile = kTop1Threads * kTop1Items;   // pixels a tile
static_assert(kTop1Items % 4 == 0, "whole 4-pixel vector loads");

// What a window kernel computes: kDark, (N, H, W, 3) -> the channel min,
// then the windowed min (+inf border); kMin, (N, H, W) -> the windowed min;
// kMean, (N, H, W) -> the windowed mean over the clipped window; kMaskedMin
// and kMaskedMean, (N, H, W) and the (H,) / (W,) validity bytes vh / vw ->
// the windowed min (invalid pixels +inf) and the windowed mean over the
// valid pixels only (divisor max(rowcnt * colcnt, 1)).
enum Window { kDark = 0, kMin = 1, kMean = 2, kMaskedMin = 3, kMaskedMean = 4 };

// grid (ceil(W/kTileX), ceil(H/kTileY), N), block (kTileX, kRowThreads),
// dynamic shared memory min(kTileY + 2r, H) * kTileX floats. vh and vw are
// read by the masked forms only.
template <int kMode>
__global__ void window_kernel(const void* __restrict__ x, void* __restrict__ out,
                              int H, int W, int r, int dt,
                              const uint8_t* __restrict__ vh,
                              const uint8_t* __restrict__ vw) {
    constexpr bool kMasked = kMode == kMaskedMin || kMode == kMaskedMean;
    constexpr bool kSum = kMode == kMean || kMode == kMaskedMean;
    extern __shared__ float hwin[];              // [row - ylo][tx]
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int col = blockIdx.x * kTileX + tx;
    const int y0 = blockIdx.y * kTileY;
    const long long plane = static_cast<long long>(blockIdx.z) * H * W;
    const int ylo = max(y0 - r, 0), yhi = min(y0 + kTileY - 1 + r, H - 1);
    const int clo = max(col - r, 0), chi = min(col + r, W - 1);

    // Horizontal windows of every input row the tile needs.
    for (int k = ylo + ty; k <= yhi; k += kRowThreads) {
        float h = kSum ? 0.0f : INFINITY;
        if (col < W && (!kMasked || vh[k])) {
            const long long row = plane + static_cast<long long>(k) * W;
            for (int c = clo; c <= chi; ++c) {
                if (kMode == kDark) {
                    const long long p = 3 * (row + c);
                    const float m = fminf(fminf(load_px(x, p, dt, 1.0f),
                                                load_px(x, p + 1, dt, 1.0f)),
                                          load_px(x, p + 2, dt, 1.0f));
                    h = fminf(h, m);
                } else if (kMasked && !vw[c]) {
                    continue;                    // +inf for the min, 0 for the sum
                } else if (kSum) {
                    h = __fadd_rn(h, load_px(x, row + c, dt, 1.0f));
                } else {
                    h = fminf(h, load_px(x, row + c, dt, 1.0f));
                }
            }
        }
        hwin[(k - ylo) * kTileX + tx] = h;
    }
    __syncthreads();
    if (col >= W) return;

    // Vertical windows over them.
    float cnt_x = static_cast<float>(chi - clo + 1);
    if (kMode == kMaskedMean) {
        int n = 0;
        for (int c = clo; c <= chi; ++c) n += vw[c] ? 1 : 0;
        cnt_x = static_cast<float>(n);
    }
    const int yend = min(y0 + kTileY, H);
    for (int y = y0 + ty; y < yend; y += kRowThreads) {
        const int lo = max(y - r, 0), hi = min(y + r, H - 1);
        float acc = kSum ? 0.0f : INFINITY;
        for (int k = lo; k <= hi; ++k) {
            const float v = hwin[(k - ylo) * kTileX + tx];
            acc = kSum ? __fadd_rn(acc, v) : fminf(acc, v);
        }
        if (kMode == kMean)
            acc = __fdiv_rn(acc, __fmul_rn(static_cast<float>(hi - lo + 1), cnt_x));
        if (kMode == kMaskedMean) {
            int n = 0;
            for (int k = lo; k <= hi; ++k) n += vh[k] ? 1 : 0;
            acc = __fdiv_rn(acc, fmaxf(__fmul_rn(static_cast<float>(n), cnt_x), 1.0f));
        }
        store_px(out, plane + static_cast<long long>(y) * W + col, dt, acc);
    }
}

// grid (tiles, N), block kTop1Threads: keys[n * tiles + j] = the smallest
// key of pixels [j * kTop1Tile, (j + 1) * kTop1Tile) of frame n of t
// (P pixels a frame, t_dt).
__global__ void __launch_bounds__(kTop1Threads)
top1_tile_kernel(const void* __restrict__ t, int t_dt, unsigned long long* __restrict__ keys,
                 long long P) {
    __shared__ unsigned long long red[kTop1Threads / 32 + 1];
    const long long n = blockIdx.y;
    const long long start = static_cast<long long>(blockIdx.x) * kTop1Tile;
    const long long count = min(static_cast<long long>(kTop1Tile), P - start);
    const long long base = n * P + start;        // element of the tile's first pixel
    const char* first = static_cast<const char*>(t) + base * (t_dt == 0 ? 4 : 2);
    const unsigned vec = t_dt == 0 ? 16u : 8u;   // bytes of 4 pixels
    unsigned long long best = kNoKey;
    if (count == kTop1Tile && reinterpret_cast<uintptr_t>(first) % vec == 0) {
        constexpr int kLoads = kTop1Items / 4;
        float v[kLoads][4];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {       // every load in flight first
            const int q = j * kTop1Threads + threadIdx.x;
            if (t_dt == 0) {
                const float4 f = reinterpret_cast<const float4*>(first)[q];
                v[j][0] = f.x;
                v[j][1] = f.y;
                v[j][2] = f.z;
                v[j][3] = f.w;
            } else {                             // bfloat16 widens by a shift
                const uint2 u = reinterpret_cast<const uint2*>(first)[q];
                v[j][0] = __uint_as_float(u.x << 16);
                v[j][1] = __uint_as_float(u.x & 0xffff0000u);
                v[j][2] = __uint_as_float(u.y << 16);
                v[j][3] = __uint_as_float(u.y & 0xffff0000u);
            }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const long long i = start + 4LL * (j * kTop1Threads + threadIdx.x) + c;
                const unsigned long long key = make_key(v[j][c], static_cast<unsigned>(i));
                best = key < best ? key : best;
            }
    } else {
        for (long long i = threadIdx.x; i < count; i += kTop1Threads) {
            const unsigned long long key =
                make_key(load_px(t, base + i, t_dt, 1.0f), static_cast<unsigned>(start + i));
            best = key < best ? key : best;
        }
    }
    best = block_min_u64<kTop1Threads>(best, red);
    if (threadIdx.x == 0) keys[n * gridDim.x + blockIdx.x] = best;
}

// grid (N,), one warp a block: out[n] = img[n] at the smallest of frame n's
// tile keys.
__global__ void top1_gather_kernel(const unsigned long long* __restrict__ keys, int tiles,
                                   const void* __restrict__ img, void* __restrict__ out,
                                   long long P, int img_dt) {
    const long long n = blockIdx.x;
    const unsigned long long m = warp_min_keys(keys + n * tiles, tiles);
    if (threadIdx.x < 3) {
        const long long px = n * P + static_cast<long long>(m & 0xffffffffULL);
        store_px(out, 3 * n + threadIdx.x, img_dt,
                 load_px(img, 3 * px + threadIdx.x, img_dt, 1.0f));
    }
}

// One thread a pixel of N*P: J (img dtype) from I, t and the frame's A.
__global__ void recover_kernel(const void* __restrict__ img, const void* __restrict__ t,
                               const void* __restrict__ A, void* __restrict__ out,
                               long long P, long long total, float t0, float gamma,
                               int img_dt, int t_dt, int a_dt) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long n = i / P;
    const float tt = fmaxf(load_px(t, i, t_dt, 1.0f), t0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float a = load_px(A, 3 * n + c, a_dt, 1.0f);
        const float x = load_px(img, 3 * i + c, img_dt, 1.0f);
        float v = clip01(__fadd_rn(__fdiv_rn(__fsub_rn(x, a), tt), a));
        if (gamma != 1.0f) v = powf(v, gamma);
        store_px(out, 3 * i + c, img_dt, v);
    }
}

// grid (N,), block kReduceThreads: out[n] (3 float32) = the mean rgb of the
// k rows of frame n with the smallest (t, gidx) keys, ties to the lower row;
// sel (N, k) int32 is scratch for the picked rows in ascending order.
__global__ void merge_topk_kernel(const float* __restrict__ t,
                                  const int* __restrict__ gidx,
                                  const float* __restrict__ rgb, int* __restrict__ sel,
                                  float* __restrict__ out, int M, int k) {
    const long long n = blockIdx.x;
    const float* tn = t + n * M;
    const int* gn = gidx + n * M;
    int* sn = sel + n * k;
    for (int i = threadIdx.x; i < M; i += kReduceThreads) {
        const unsigned long long key =
            make_key(tn[i], static_cast<unsigned>(gn[i]) ^ 0x80000000u);
        int rank = 0;
        for (int j = 0; j < M && rank < k; ++j) {
            const unsigned long long other =
                make_key(tn[j], static_cast<unsigned>(gn[j]) ^ 0x80000000u);
            rank += (other < key || (other == key && j < i)) ? 1 : 0;
        }
        if (rank < k) sn[rank] = i;              // ranks are distinct
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float sr = 0.0f, sg = 0.0f, sb = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
        for (int s = 0; s < k; ++s) {
            const float* p = rgb + 3 * (n * M + sn[s]);
            comp_add(sr, cr, p[0]);
            comp_add(sg, cg, p[1]);
            comp_add(sb, cb, p[2]);
        }
        const float kf = static_cast<float>(k);
        out[3 * n] = __fdiv_rn(__fadd_rn(sr, cr), kf);
        out[3 * n + 1] = __fdiv_rn(__fadd_rn(sg, cg), kf);
        out[3 * n + 2] = __fdiv_rn(__fadd_rn(sb, cb), kf);
    }
}

template <int kMode>
int launch_window(const void* x, void* out, int N, int H, int W, int r, int dt,
                  void* stream, const uint8_t* vh = nullptr,
                  const uint8_t* vw = nullptr) {
    const int rows = min(kTileY + 2 * r, H);
    const size_t smem = static_cast<size_t>(rows) * kTileX * sizeof(float);
    if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            window_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, N);
    window_kernel<kMode><<<grid, dim3(kTileX, kRowThreads), smem,
                           static_cast<cudaStream_t>(stream)>>>(x, out, H, W, r, dt,
                                                                vh, vw);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int st_tile_x() { return kTileX; }
int st_tile_y() { return kTileY; }
int st_max_smem() { return kMaxSmem; }
int st_topk_tile() { return kTopkTile; }
int st_topk_max_tiles() { return kTopkMaxLists; }
int st_top1_tile() { return kTop1Tile; }

// (N, H, W, 3) -> (N, H, W), both in dt (0 float32, 1 bfloat16).
int st_dark_channel(const void* img, void* out, int N, int H, int W, int radius,
                    int dt, void* stream) {
    return launch_window<kDark>(img, out, N, H, W, radius, dt, stream);
}

// (N, H, W) -> (N, H, W), both in dt.
int st_min_filter(const void* x, void* out, int N, int H, int W, int radius, int dt,
                  void* stream) {
    return launch_window<kMin>(x, out, N, H, W, radius, dt, stream);
}

// (N, H, W) -> (N, H, W), both in dt.
int st_box_filter(const void* x, void* out, int N, int H, int W, int radius, int dt,
                  void* stream) {
    return launch_window<kMean>(x, out, N, H, W, radius, dt, stream);
}

// (N, H, W) in dt, (H,) and (W,) validity bytes -> (N, H, W) in dt, the
// windowed min with invalid pixels +inf.
int st_masked_min_filter(const void* x, const uint8_t* vh, const uint8_t* vw,
                         void* out, int N, int H, int W, int radius, int dt,
                         void* stream) {
    return launch_window<kMaskedMin>(x, out, N, H, W, radius, dt, stream, vh, vw);
}

// (N, H, W) in dt, (H,) and (W,) validity bytes -> (N, H, W) in dt, the
// windowed mean over the valid pixels (0 where a window has none).
int st_masked_box_filter(const void* x, const uint8_t* vh, const uint8_t* vw,
                         void* out, int N, int H, int W, int radius, int dt,
                         void* stream) {
    return launch_window<kMaskedMean>(x, out, N, H, W, radius, dt, stream, vh, vw);
}

// (N, M) float32 t, (N, M) int32 global index, (N, M, 3) float32 rgb ->
// (N, 3) float32, the mean rgb of the k smallest (t, index) rows, 1 <= k <= M;
// sel is scratch for N x k int32.
int st_merge_topk(const float* t, const int* gidx, const float* rgb, int* sel,
                  float* out, int N, int M, int k, void* stream) {
    if (k < 1 || k > M) return static_cast<int>(cudaErrorInvalidValue);
    merge_topk_kernel<<<N, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t, gidx, rgb, sel, out, M, k);
    return static_cast<int>(cudaGetLastError());
}

// (N, H, W, 3) img_dt, (N, H, W) t_dt -> (N, 3) img_dt, I at the smallest
// (t, flat index) key of each frame; keys is scratch for N x
// ceil(H*W / st_top1_tile()) keys.
int st_atmolight(const void* img, const void* t, unsigned long long* keys, void* out,
                 int N, int H, int W, int img_dt, int t_dt, void* stream) {
    const long long P = static_cast<long long>(H) * W;
    const int tiles = static_cast<int>((P + kTop1Tile - 1) / kTop1Tile);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    top1_tile_kernel<<<dim3(tiles, N), kTop1Threads, 0, s>>>(t, t_dt, keys, P);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    top1_gather_kernel<<<N, 32, 0, s>>>(keys, tiles, img, out, P, img_dt);
    return static_cast<int>(cudaGetLastError());
}

// (N, H, W, 3) img_dt, (N, H, W) t_dt -> (N, 3) img_dt, the mean of I over
// the k smallest (t, flat index) keys of each frame, 1 <= k <= H*W; keys is
// scratch for N x ceil(H*W / st_topk_tile()) x min(k, st_topk_tile()) keys.
int st_atmolight_topk(const void* img, const void* t, unsigned long long* keys,
                      void* out, int N, int H, int W, int k, int img_dt, int t_dt,
                      void* stream) {
    const long long P = static_cast<long long>(H) * W;
    const long long n_tiles = (P + kTopkTile - 1) / kTopkTile;
    if (k < 1 || k > P || n_tiles > kTopkMaxLists)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    topk_block_kernel<<<dim3(static_cast<unsigned>(n_tiles), N), kTopkThreads, 0, s>>>(
        t, t_dt, keys, P, tile_keep(k));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    topk_merge_kernel<<<N, kTopkThreads, 0, s>>>(
        keys, static_cast<int>(n_tiles), tile_keep(k), k, img, img_dt, 1.0f, P, out,
        img_dt, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// (N, H, W, 3) img_dt, (N, H, W) t_dt, (N, 3) a_dt -> (N, H, W, 3) img_dt.
int st_recover(const void* img, const void* t, const void* A, void* out, int N, int H,
               int W, float t0, float gamma, int img_dt, int t_dt, int a_dt,
               void* stream) {
    const long long P = static_cast<long long>(H) * W;
    const long long total = P * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    recover_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, t, A, out, P, total, t0, gamma, img_dt, t_dt, a_dt);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
