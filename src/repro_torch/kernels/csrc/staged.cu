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
// whole frame in VMEM; a 480x640 float32 plane is 1.2 MB against at most
// 227 KB of shared memory a block. Windows are taken horizontally, then
// vertically, each clipped to the frame (+inf for the min, a closed-form
// count for the mean), so any radius works, also r = 0 and windows wider
// than the frame. The min is a pure selection and equals its plain version
// bit for bit. The mean is a direct sum over the clipped window, its terms
// in ascending order from +0, divided by the closed-form in-bounds count:
// not the Pallas kernel's cumsum differences but the same function, better
// conditioned for the guided filter's var_g = corr_gg - mean_g^2 over var_g
// + eps; the plain version adds the same terms in the same order, so the
// two are equal bit for bit.
//
// The dark channel and the box filter (B3a, B4) run as window strips: a
// block takes a 64-column strip of a frame over a band of at most 128
// output rows (64 for B3a; the host evens the bands out: 4 of 120 rows, 8
// of 60, at H = 480) and walks down its input rows 32 at a time, each
// piece into float32 rows of shared memory (odd row stride, so a warp's
// lanes on 32 rows hit 32 banks), the fill off the frame (+0 for the sum,
// +inf for the min). The float32 box filter copies its plane straight into
// those rows with cp.async, 4 bytes a copy, zero-filled off the frame, two
// pieces in flight (16-byte copies would need rows on 16-byte boundaries,
// a stride that puts 4 of the 32 rows on each bank). B3a, and the bfloat16
// box filter, load the piece's pixels from device memory, a warp's lanes
// on adjacent pixels, and store them as float32, B3a the min of each
// pixel's three channels, taken once a pixel: staging the raw RGB rows
// would take three times the shared memory of the float32 piece and halve
// the blocks an SM. Then the horizontal windows of the piece's rows, a
// warp's lanes on its 32 rows, each thread a register-blocked run of 8
// outputs that fetches each input once (window_run, shared with the
// megakernel's tiled passes), into the band's horizontal sums; last the
// vertical windows of the band's outputs, 8 a thread, from those sums,
// straight to device memory. A term off the frame is +0, which leaves a sum
// from +0 unchanged, so the strips compute window_kernel<kMean>'s sums bit
// for bit. A strip's input rows are recomputed (band + 2r)/band times,
// 1.33 at r = 20, against 1.63 for window_kernel's 64-row tiles; its
// columns (64 + 2r)/64 times. Shared memory grows with r (the band's sums
// and a piece's halo): the strips take r up to 175 on float32 planes (243
// bfloat16) for the box filter and up to 265 for the dark channel
// (st_strips_fit; He et al.'s guided filter uses r = 60), and
// st_box_filter_wide / st_dark_channel_wide launch window_kernel for wider
// windows. The caller picks one from the shape before it launches
// (kernels/staged.py::strips_fit); a strip entry point given a radius it
// does not take returns cudaErrorInvalidValue and launches nothing.
//
// window_kernel (the min filter, the masked forms, and B3a/B4 past the
// strips' radius): a block computes a kTileY x kTileX output tile, each
// thread of a warp one output column: first the horizontal window of every
// input row the tile's vertical windows touch (kTileY + 2r rows, at most H)
// goes into shared memory, read tap by tap from device memory, then the
// vertical window is taken from there; shared memory is min(kTileY + 2r,
// H) * kTileX floats.
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
// of the plane they filter), the merge by its 20 bytes a row. The box
// filter's direct sums bound it about as much: (2r + 1) adds an output an
// axis, 94.8 at r = 20 with the strips' recomputed rows, 0.028 ms at the
// card's 33.5 T/s of float32 adds. window_kernel reaches neither: each
// window tap is a load (2r + 1 per output per axis, the dark channel's
// three channels each time).
//
// Rounding: IEEE division and powf (no fast math, --fmad=false), float32
// constants rounded on the Python side exactly as PyTorch rounds a scalar
// operand. Every entry point launches on the caller's stream, allocates
// nothing and returns the cudaError_t of its launch (0 on success).

#include <atomic>

#include "dehaze_common.cuh"

namespace {

using namespace dehaze;

constexpr int kTileX = 32;                       // output columns a block (one warp)
constexpr int kTileY = 64;                       // output rows a block
constexpr int kRowThreads = 8;                   // warps a window block
constexpr int kReduceThreads = 1024;             // threads of a merge_topk block
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

// ---------------------------------------------------------------------------
// Window strips (B3a st_dark_channel, B4 st_box_filter): one block a
// kStripW-column strip of one frame, over a band of at most kBandRows
// (kDarkBandRows) output rows, walking down the band in pieces of
// kPieceRows input rows.
// ---------------------------------------------------------------------------

constexpr int kStripW = 64;                      // output columns of a strip
constexpr int kPieceRows = 32;                   // input rows staged at a time
constexpr int kBandRows = 128;                   // most output rows a box filter block
constexpr int kDarkBandRows = 64;                // the same for the dark channel
constexpr int kStripThreads = 256;
constexpr int kRunX = 8;                         // horizontal window outputs a thread
constexpr int kRunY = 8;                         // vertical window outputs a thread
constexpr int kSumStride = kStripW + 1;          // a row of horizontal sums (odd)
static_assert(kPieceRows == 32, "a warp's lanes are a piece's rows in the horizontal runs");
static_assert((kStripW / kRunX) * kPieceRows == kStripThreads, "one horizontal run a thread");
static_assert(kStripThreads % kStripW == 0, "whole vertical runs a round of a band");

// Whether a strip block copies its pieces straight into the float32 rows
// its horizontal runs read (the float32 box filter: cp.async, 4 bytes a
// copy, two pieces in flight), or loads each piece's pixels from device
// memory and stores them as float32 (bfloat16, and the dark channel's
// channel min).
__host__ __device__ constexpr bool strip_direct(int mode, int dt) {
    return mode == kMean && dt == 0;
}

// Input columns of a strip: its outputs and their halo.
__host__ __device__ __forceinline__ long long strip_cols(long long r) {
    return kStripW + 2 * r;
}

// Shared memory of a strip block with bands of `band` rows: a piece in
// float32 (odd row stride; strip_direct: two), and the horizontal sums of
// every input row a band's windows touch, with room for a last vertical
// run that passes the band's end (its outputs are not stored). 64-bit, as
// the radius may be any int.
__host__ __device__ __forceinline__ long long strip_smem(long long r, int mode, int dt,
                                                         int band) {
    const long long piece = 4LL * kPieceRows * (strip_cols(r) | 1);
    return (strip_direct(mode, dt) ? 2 : 1) * piece +
           4 * (band + 2 * r + kRunY - 1) * kSumStride;
}

// Most output rows of a strip block: the dark channel's pixels come from
// device memory, and its shorter bands (less shared memory a block) put
// more blocks, and more loads in flight, on an SM.
__host__ __device__ constexpr int strip_band_rows(int mode) {
    return mode == kDark ? kDarkBandRows : kBandRows;
}

// Whether a strip block of the tallest band fits a block's shared memory:
// the strips take every such radius; st_dark_channel_wide and
// st_box_filter_wide take the rest.
__host__ __device__ __forceinline__ bool strips_fit(int mode, int r, int dt) {
    return r >= 0 && strip_smem(r, mode, dt, strip_band_rows(mode)) <= kMaxSmem;
}

// grid (ceil(W / kStripW), ceil(H / band), N), block kStripThreads,
// strip_smem(r, kMode, kDt, band) bytes. kMode kDark: (N, H, W, 3) -> the
// channel min, then the windowed min (+inf off the frame); kMean: (N, H,
// W) -> the windowed mean over the clipped window. kDt: 0 float32, 1
// bfloat16, in and out. A block walks down its input rows (its band and r
// above and below) a piece of kPieceRows rows at a time, into float32 rows
// with the fill off the frame (see the head of this file for how each
// form fills them); the horizontal windows of a piece's rows, a warp's
// lanes on its 32 rows, a run of kRunX outputs a thread, go into the band's
// horizontal sums; last the vertical windows of the band's outputs, a run
// of kRunY a thread, straight to out. Each sum adds its terms in ascending
// order from +0, horizontal then vertical, and the mean divides once by the
// closed-form count: the terms, order and division of window_kernel<kMean>,
// with +0 for each term off the frame, which leaves a sum from +0
// unchanged bit for bit.
template <int kMode, int kDt>
__global__ void __launch_bounds__(kStripThreads)
strip_window_kernel(const void* __restrict__ x, void* __restrict__ out, int H, int W, int r,
                    int band) {
    constexpr bool kSum = kMode == kMean;
    constexpr bool kDirect = strip_direct(kMode, kDt);
    constexpr int kWarps = kStripThreads / 32;
    extern __shared__ __align__(16) uint8_t smem[];
    const float fill = kSum ? 0.0f : INFINITY;
    const int cols = static_cast<int>(strip_cols(r)), fstride = cols | 1;
    const int piece_floats = kPieceRows * fstride;
    // flt[kPieceRows][fstride] (kDirect: two), then
    // hsum[band + 2r + kRunY - 1][kSumStride].
    float* flt = reinterpret_cast<float*>(smem);
    float* hsum = flt + (kDirect ? 2 : 1) * piece_floats;
    const int x0 = blockIdx.x * kStripW, xf = x0 - r;   // first output, first input column
    const int y0 = blockIdx.y * band, rows_out = min(band, H - y0);
    const int need = rows_out + 2 * r;           // input rows, from y0 - r
    const int pieces = (need + kPieceRows - 1) / kPieceRows;
    const long long frame = static_cast<long long>(blockIdx.z) * H * W;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // kDirect: starts the copies of piece p's rows that lie in the frame
    // (zeros for their columns off it) into buffer p & 1.
    auto stage = [&](int p) {
        if (p >= pieces) return;
        for (int i = warp; i < kPieceRows; i += kWarps) {
            const int rel = p * kPieceRows + i, y = y0 - r + rel;
            if (rel >= need || y < 0 || y >= H) continue;
            const float* src = static_cast<const float*>(x) + frame + static_cast<long long>(y) * W;
            float* dst = flt + (p & 1) * piece_floats + i * fstride;
            for (int j = lane; j < cols; j += 32) {
                const int xx = xf + j;
                const bool in = xx >= 0 && xx < W;
                cp_async4(dst + j, in ? src + xx : src, in ? 4 : 0);
            }
        }
    };

    if constexpr (kDirect) {
        stage(0);
        cp_async_commit();
        stage(1);
        cp_async_commit();
    }
    for (int p = 0; p < pieces; ++p) {
        if constexpr (kDirect) cp_async_wait_group<1>();   // piece p landed
        __syncthreads();                         // and every thread's copies; flt read
        const float* piece = flt + (kDirect ? (p & 1) * piece_floats : 0);
        if constexpr (!kDirect) {
            // Piece p in float32 from device memory: a warp a row, its
            // lanes along it; the loads of a warp's rows do not wait on
            // each other.
#pragma unroll
            for (int i = warp; i < kPieceRows; i += kWarps) {
                const int rel = p * kPieceRows + i, y = y0 - r + rel;
                if (rel >= need || y < 0 || y >= H) continue;   // rows off the frame: no runs
                const long long row = frame + static_cast<long long>(y) * W;
                float* dst = flt + i * fstride;
#pragma unroll 4
                for (int j = lane; j < cols; j += 32) {
                    const int xx = xf + j;
                    const bool in = xx >= 0 && xx < W;
                    const long long e = row + (in ? xx : 0);
                    float v;
                    if constexpr (kMode == kDark)
                        v = fminf(fminf(load_px(x, 3 * e, kDt, 1.0f),
                                        load_px(x, 3 * e + 1, kDt, 1.0f)),
                                  load_px(x, 3 * e + 2, kDt, 1.0f));
                    else
                        v = load_px(x, e, kDt, 1.0f);
                    dst[j] = in ? v : fill;
                }
            }
            __syncthreads();                     // piece p in flt
        }
        // The horizontal runs: a warp's lanes are the piece's rows.
        const int rel = p * kPieceRows + lane, y = y0 - r + rel, c0 = warp * kRunX;
        if (rel < need) {
            float s[1][kRunX];
            if (y >= 0 && y < H) {
                const float* src = piece + lane * fstride + c0;
                window_run<1, kRunX, kSum>([&](int k, float (&v)[1]) { v[0] = src[k]; }, 2 * r,
                                           s);
            } else {
#pragma unroll
                for (int j = 0; j < kRunX; ++j) s[0][j] = fill;
            }
#pragma unroll
            for (int j = 0; j < kRunX; ++j) hsum[rel * kSumStride + c0 + j] = s[0][j];
        }
        if constexpr (kDirect) {
            __syncthreads();                     // buffer p & 1 read
            stage(p + 2);
            cp_async_commit();
        }
    }
    __syncthreads();                             // every horizontal sum written

    // The vertical runs: a warp's lanes are adjacent columns; output row o's
    // window is input rows o .. o + 2r counted from y0 - r.
    const int c = threadIdx.x % kStripW, xo = x0 + c;
    const float cnt_x = static_cast<float>(win_count(xo, W, r));
    for (int o0 = (threadIdx.x / kStripW) * kRunY; o0 < rows_out;
         o0 += kRunY * (kStripThreads / kStripW)) {
        const float* src = hsum + o0 * kSumStride + c;
        float s[1][kRunY];
        window_run<1, kRunY, kSum>([&](int k, float (&v)[1]) { v[0] = src[k * kSumStride]; },
                                   2 * r, s);
        if (xo >= W) continue;
#pragma unroll
        for (int q = 0; q < kRunY; ++q) {
            const int y = y0 + o0 + q;
            float v = s[0][q];
            if constexpr (kSum)
                v = __fdiv_rn(v, __fmul_rn(static_cast<float>(win_count(y, H, r)), cnt_x));
            if (o0 + q < rows_out) store_px(out, frame + static_cast<long long>(y) * W + xo, kDt, v);
        }
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

// The band's rows and the shared memory of the strips on frames of H rows
// at radius r, and past 48 KB the kernel's opt-in to it: a host call, made
// only when a larger size than any before is asked for, not at every
// launch. 0 where the strips do not take r.
template <int kMode, int kDt>
size_t strips_opt_in(int H, int r, int& band, cudaError_t& e) {
    e = cudaSuccess;
    if (!strips_fit(kMode, r, kDt)) {
        e = cudaErrorInvalidValue;
        return 0;
    }
    const int bands = (H + strip_band_rows(kMode) - 1) / strip_band_rows(kMode);
    band = (H + bands - 1) / bands;
    const size_t smem = static_cast<size_t>(strip_smem(r, kMode, kDt, band));
    static std::atomic<size_t> opted{48 * 1024};
    if (smem > opted.load()) {
        e = cudaFuncSetAttribute(strip_window_kernel<kMode, kDt>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e == cudaSuccess) opted.store(smem);
    }
    return smem;
}

template <int kMode, int kDt>
int launch_strips(const void* x, void* out, int N, int H, int W, int r, void* stream) {
    int band = 0;
    cudaError_t e;
    const size_t smem = strips_opt_in<kMode, kDt>(H, r, band, e);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((W + kStripW - 1) / kStripW, (H + band - 1) / band, N);
    strip_window_kernel<kMode, kDt><<<grid, kStripThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(x, out, H, W, r,
                                                                           band);
    return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_strips(const void* x, void* out, int N, int H, int W, int r, int dt,
                  void* stream) {
    return dt == 0 ? launch_strips<kMode, 0>(x, out, N, H, W, r, stream)
                   : launch_strips<kMode, 1>(x, out, N, H, W, r, stream);
}

// Blocks an SM of the strips on frames of H rows at radius r, from the
// occupancy calculator (launches nothing).
template <int kMode, int kDt>
int strips_occupancy(int H, int r, int* blocks) {
    int band = 0;
    cudaError_t e;
    const size_t smem = strips_opt_in<kMode, kDt>(H, r, band, e);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, strip_window_kernel<kMode, kDt>,
                                                          kStripThreads, smem);
    return static_cast<int>(e);
}

}  // namespace

extern "C" {

int st_tile_x() { return kTileX; }
int st_tile_y() { return kTileY; }
int st_max_smem() { return kMaxSmem; }
int st_topk_tile() { return kTopkTile; }
int st_topk_max_tiles() { return kTopkMaxLists; }
int st_top1_tile() { return kTop1Tile; }
int st_strip_w() { return kStripW; }
int st_piece_rows() { return kPieceRows; }
int st_band_rows() { return kBandRows; }
int st_dark_band_rows() { return kDarkBandRows; }

// 1 where the strips take the dark channel (dark = 1) or the box filter
// (dark = 0) at this radius and dtype, else 0.
int st_strips_fit(int dark, int radius, int dt) {
    return strips_fit(dark ? kDark : kMean, radius, dt) ? 1 : 0;
}

// *blocks = blocks an SM of the dark channel's (dark = 1) or the box
// filter's strips on frames of H rows at this radius and dtype.
int st_strips_occupancy(int dark, int radius, int dt, int H, int* blocks) {
    if (dark) return dt == 0 ? strips_occupancy<kDark, 0>(H, radius, blocks)
                             : strips_occupancy<kDark, 1>(H, radius, blocks);
    return dt == 0 ? strips_occupancy<kMean, 0>(H, radius, blocks)
                   : strips_occupancy<kMean, 1>(H, radius, blocks);
}

// (N, H, W, 3) -> (N, H, W), both in dt (0 float32, 1 bfloat16): the
// strips, where st_strips_fit(1, radius, dt).
int st_dark_channel(const void* img, void* out, int N, int H, int W, int radius,
                    int dt, void* stream) {
    return launch_strips<kDark>(img, out, N, H, W, radius, dt, stream);
}

// The same by window_kernel, for radii the strips do not take.
int st_dark_channel_wide(const void* img, void* out, int N, int H, int W, int radius,
                         int dt, void* stream) {
    return launch_window<kDark>(img, out, N, H, W, radius, dt, stream);
}

// (N, H, W) -> (N, H, W), both in dt.
int st_min_filter(const void* x, void* out, int N, int H, int W, int radius, int dt,
                  void* stream) {
    return launch_window<kMin>(x, out, N, H, W, radius, dt, stream);
}

// (N, H, W) -> (N, H, W), both in dt: the strips, where
// st_strips_fit(0, radius, dt).
int st_box_filter(const void* x, void* out, int N, int H, int W, int radius, int dt,
                  void* stream) {
    return launch_strips<kMean>(x, out, N, H, W, radius, dt, stream);
}

// The same by window_kernel, for radii the strips do not take.
int st_box_filter_wide(const void* x, void* out, int N, int H, int W, int radius, int dt,
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
