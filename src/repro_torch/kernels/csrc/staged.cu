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
// and, merged into one kernel with the Section 3.3 EMA that consumes its
// output, the state sync of every step whose EMA ran in PyTorch ops:
//   st_merge_ema          src/repro/kernels/atmolight.py::merge_topk_pallas and
//                         src/repro/core/normalize.py::ema_scan,
//                         ::ema_scan_associative (no Pallas kernel: jnp ops)
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
// The dark channel, the min filter and the box filter (B3a, B3b, B4), and
// the masked min and box filters (B8a, B8b), run as window strips: a block
// takes a 64-column strip of a frame over a band
// of at most 128 output rows (64 for B3a; the host evens the bands out: 4
// of 120 rows, 8 of 60, at H = 480) and walks down its input rows
// 32 at a time, each piece into float32 rows of shared memory (odd row
// stride, so a warp's lanes on 32 rows hit 32 banks), the fill off the
// frame (+0 for the sum, +inf for the min). The float32 box and min
// filters (masked or not) copy their plane straight into those rows with cp.async, 4
// bytes a copy, two pieces in flight, the columns off the frame zero-filled
// by the copies (the sum) or stored as +inf (the min) (16-byte copies would
// need rows on 16-byte boundaries, a stride that puts 4 of the 32 rows on
// each bank). B3a, and the bfloat16 planes, load the piece's pixels from
// device memory, a warp's lanes on adjacent pixels, and store them as
// float32, B3a the min of each pixel's three channels, taken once a pixel:
// staging the raw RGB rows would take three times the shared memory of the
// float32 piece and halve the blocks an SM. Then the horizontal windows of
// the piece's rows, a warp's lanes on its 32 rows, each thread a
// register-blocked run of 8 outputs that fetches each input once
// (window_run, shared with the megakernel's tiled passes; B3b's min_run
// takes each run's minima as van Herk / Gil-Werman do, about 4.75 an output
// at r = 7 instead of 15), into the band's horizontal sums; last the
// vertical windows of the band's outputs, 8 a thread, from those sums,
// straight to device memory. A term off the frame is +0, which leaves a sum
// from +0 unchanged, so the strips compute window_kernel<kMean>'s sums bit
// for bit; a min is a selection, equal in any order. A strip's input rows
// are recomputed (band + 2r)/band times, 1.33 at r = 20, against 1.63 for
// window_kernel's 64-row tiles; its columns (64 + 2r)/64 times. Shared
// memory grows with r (the band's sums and a piece's halo): the strips
// take r up to 175 on float32 planes (243 bfloat16) for the box and min
// filters, 170 (236) for their masked forms and up to 265 for the dark
// channel (st_strips_fit; He et al.'s guided filter uses r = 60), and the
// _wide entry points launch window_kernel for wider windows. The caller
// picks one from the shape before it launches (kernels/staged.py::
// strips_fit); a strip entry point given a radius it does not take returns
// cudaErrorInvalidValue and launches nothing.
//
// window_kernel (every window kernel past the strips' radius, and the one
// the strips replaced): a block computes a kTileY x kTileX output tile, each
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
// top-k into k rows carried through its sequential grid. Two routes, the
// caller picking one by k before it launches (kernels/staged.py::
// warp_topk_fits). For k <= kWarpTopkMax (16), the warp top-k
// (st_atmolight_topk), B6a's two launches with k keys for one: a grid of
// (tiles, N) blocks of kTop1Tile pixels with B6a's 16-byte loads, each lane
// keeping its 16 pixels' K smallest keys in registers by a branch-free
// insertion (K the next of 2, 4, 8, 16 from k, a template), each warp
// taking its k smallest from its lanes' lists in k rounds of a warp
// minimum (the lane holding it pops it), warp 0 the tile's from the
// warps' after one barrier (the old route's tiles pay 2k), then one warp a
// frame doing the same over its tiles' lists. Past it, for any k up to
// H*W (st_atmolight_topk_wide), the top-k kernels of dehaze_common.cuh,
// which the megakernel's candidate passes launch too: per-tile lists of
// the kk = min(k, 2048) smallest keys, one block a tile and kk block-wide
// rounds, then one block a frame merging the list heads, k rounds. Both
// take the mean of I over the k picks as a compensated float32 sum in
// ascending (t, index) order over k, cast to the frames' dtype, so they
// agree bit for bit. The caller gives the key lists' scratch (N x tiles x
// k keys; the wide route's N x tiles x kk).
//
// Masked windows (the halo-extended planes of a spatial shard, and the
// whole planes of the staged sharded step). The masked forms take an (H,)
// row and a (W,) column validity vector (bytes, 0 = invalid): the min
// takes an invalid pixel as +inf; the mean leaves it out of the sum and
// divides by max(rowcnt(y) * colcnt(x), 1), each count the windowed sum of
// its axis's mask. An invalid pixel may hold +-inf or NaN from upstream,
// so it is never read into an operation, only replaced (a select, not a
// multiply): the strips take the mask where a piece is staged (an invalid
// column is the fill, an invalid row takes no runs), and take each
// block's counts from prefix counts of its valid columns and rows, once a
// block; a block with every input column and row valid skips the mask.
// The reference's XLA filter divides by the windowed sum of the 2-D mask;
// the masks are outer products, so the two are the same integer, and the
// product is cheaper.
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
// State sync (st_merge_ema). Every step but the lane-native megakernel
// ends in the same seam: each frame's candidate rows (M = shards x k after
// a spatial step's all-gathers, M = 1 where the stage already gave one row
// a frame), then the lane's EMA over its B frames. As separate calls that
// seam was B10's launch (M > 1) and about 60 PyTorch launches of the
// associative scan at B = 8, each a few hundred bytes: launch-bound, on
// the device and on the host. One block a lane does
// all of it in one launch: a warp a frame ranks its M rows as
// merge_topk_kernel does (the same keys, M^2 compares, ties to the lower
// row), lanes 0-2 sum the k picks' rgb in ascending order with the
// compensated sum and divide by k into a_seq (a row passes through
// untouched at M = 1), then thread 0 runs the B steps of Eq. 9 in order,
// in the form the caller names: sequential (ema_step, as ema_scan) or the
// associative scan's own order of operations (the closed-form update
// positions u0 = max(fid0, k0 + period), or fid0 uninitialized, then every
// period ids; the bootstrap at the first valid frame; c_i = 1 - lam*m_i
// (0 at the bootstrap), d_i = lam*m_i*cand_i (cand_i there);
// cc_i = c_i*cc_{i-1}, dd_i = c_i*dd_{i-1} + d_i; a_i = cc_i*A0 + dd_i;
// last_update the largest updating id), each product and sum rounded
// alone as PyTorch's eager ops round them, so both forms equal their
// PyTorch versions bit for bit. The two forms differ where ids skip.
// Bound: the lists, ids, state and a_seq read or written once, a few
// hundred bytes: what is left is the launch.
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
// of the plane they filter, the validity bytes besides), the merge by its
// 20 bytes a row. The box
// filter's direct sums bound it about as much: (2r + 1) adds an output an
// axis, 94.8 at r = 20 with the strips' recomputed rows, 0.028 ms at the
// card's 33.5 T/s of float32 adds; the min filter's direct minima would
// too (30 an output at r = 7), hence min_run. window_kernel reaches
// neither: each window tap is a load (2r + 1 per output per axis, the dark
// channel's three channels each time).
//
// Rounding: IEEE division and powf (no fast math, --fmad=false), float32
// constants rounded on the Python side exactly as PyTorch rounds a scalar
// operand. Every entry point launches on the caller's stream, allocates
// nothing and returns the cudaError_t of its launch (0 on success).

#include <atomic>
#include <type_traits>

#include "dehaze_common.cuh"

namespace {

using namespace dehaze;

constexpr int kTileX = 32;                       // output columns a block (one warp)
constexpr int kTileY = 64;                       // output rows a block
constexpr int kRowThreads = 8;                   // warps a window block
constexpr int kReduceThreads = 1024;             // threads of a merge_topk block
constexpr int kMergeEmaWarps = 8;                // warps of a merge_ema block at M > 1
constexpr int kMergeEmaMaxK = 1024;              // picks a frame (k ints a warp of scratch)
constexpr int kBootstrapId = -(1 << 30);         // last_update of a fresh stream
constexpr int kTop1Threads = 256;                // threads of an atmolight tile block
constexpr int kTop1Items = 16;                   // pixels a thread, by default
constexpr int kTop1Tile = kTop1Threads * kTop1Items;   // pixels a tile, by default
// The tile is B6a's and B6b's tuning knob (kernels/tuning.py, ops atmolight
// and atmolight_topk: tile_pixels), a template parameter of their tile
// kernels: kItems pixels a thread, kTop1Threads * kItems a tile, each
// 4-pixel loads (with_top1_items: 2048, 4096 or 8192 pixels). Keys are
// unique and a frame's picks are its smallest keys over all its tiles, summed
// in key order, so no tile changes an output bit.

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
constexpr int kMinBandRows = 128;                // and for the min filter
constexpr int kStripThreads = 256;
constexpr int kRunX = 8;                         // horizontal window outputs a thread
constexpr int kRunY = 8;                         // vertical window outputs a thread
constexpr int kSumStride = kStripW + 1;          // a row of horizontal sums (odd)
static_assert(kPieceRows == 32, "a warp's lanes are a piece's rows in the horizontal runs");
static_assert((kStripW / kRunX) * kPieceRows == kStripThreads, "one horizontal run a thread");
static_assert(kStripThreads % kStripW == 0, "whole vertical runs a round of a band");

// Whether a strip block copies its pieces straight into the float32 rows
// its horizontal runs read (the float32 box and min filters and their
// masked forms: cp.async, 4 bytes a copy, two pieces in flight), or loads
// each piece's pixels from device memory and stores them as float32
// (bfloat16, and the dark channel's channel min).
__host__ __device__ constexpr bool strip_direct(int mode, int dt) {
    return mode != kDark && dt == 0;
}

// The masked forms (B8a kMaskedMin, B8b kMaskedMean).
__host__ __device__ constexpr bool strip_masked(int mode) {
    return mode == kMaskedMin || mode == kMaskedMean;
}

// Input columns of a strip: its outputs and their halo.
__host__ __device__ __forceinline__ long long strip_cols(long long r) {
    return kStripW + 2 * r;
}

// Shared memory of a strip block with bands of `band` rows: a piece in
// float32 (odd row stride; strip_direct: two), and the horizontal sums of
// every input row a band's windows touch, with room for a last vertical
// run that passes the band's end (its outputs are not stored); the masked
// forms then the prefix counts of the strip's valid input columns and of
// the band's valid input rows (int, one more than the columns and rows),
// and the columns' and rows' validity bytes. 64-bit, as the radius may be
// any int.
__host__ __device__ __forceinline__ long long strip_smem(long long r, int mode, int dt,
                                                         int band) {
    const long long piece = 4LL * kPieceRows * (strip_cols(r) | 1);
    const long long cols = strip_cols(r), rows = band + 2 * r;
    return (strip_direct(mode, dt) ? 2 : 1) * piece +
           4 * (band + 2 * r + kRunY - 1) * kSumStride +
           (strip_masked(mode) ? 4 * (cols + 1) + 4 * (rows + 1) + cols + rows : 0);
}

// Most output rows of a strip block: the dark channel's pixels come from
// device memory, and its shorter bands (less shared memory a block) put
// more blocks, and more loads in flight, on an SM.
__host__ __device__ constexpr int strip_band_rows(int mode) {
    return mode == kDark ? kDarkBandRows
           : mode == kMin || mode == kMaskedMin ? kMinBandRows : kBandRows;
}

// Register-blocked running minimum (van Herk / Gil-Werman within a run):
// acc[j] (j < R) = the min of v(j) .. v(j + w), where fetch(k) returns
// v(k); R + w fetches, as window_run, but about w + 3R minima for the R
// outputs, not R (w + 1). Where w + 1 >= R, every output's window holds
// v(R - 1) .. v(w), the core, whose min is taken once; output j takes it
// with the suffix min of v(j) .. v(R - 2) and the prefix min of v(w + 1)
// .. v(w + j). Narrower windows take each output's window directly. A
// min is a selection, so any order of minima gives window_run's value.
template <int R, class Fetch>
__device__ __forceinline__ void min_run(const Fetch& fetch, int w, float (&acc)[R]) {
    if (w + 1 >= R) {
        float suf[R - 1];                        // suf[j] = min v(j) .. v(R - 2)
        suf[R - 2] = fetch(R - 2);
#pragma unroll
        for (int j = R - 3; j >= 0; --j) suf[j] = fminf(fetch(j), suf[j + 1]);
        float core = fetch(R - 1);
        for (int k = R; k <= w; ++k) core = fminf(core, fetch(k));
        acc[0] = fminf(suf[0], core);
        float pre = INFINITY;                    // min v(w + 1) .. v(w + j)
#pragma unroll
        for (int j = 1; j < R; ++j) {
            pre = j == 1 ? fetch(w + 1) : fminf(pre, fetch(w + j));
            acc[j] = j < R - 1 ? fminf(fminf(suf[j], core), pre) : fminf(core, pre);
        }
    } else {
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = INFINITY;
        for (int k = 0; k < R + w; ++k) {
            const float v = fetch(k);
#pragma unroll
            for (int j = 0; j < R; ++j)
                if (static_cast<unsigned>(k - j) <= static_cast<unsigned>(w))
                    acc[j] = fminf(acc[j], v);
        }
    }
}

// Whether a strip block of the tallest band fits a block's shared memory
// (which holds its input columns to far fewer than the 32 x 32 a lane's
// column bits cover): the strips take every such radius; the _wide entry
// points (window_kernel) take the rest.
__host__ __device__ __forceinline__ bool strips_fit(int mode, int r, int dt) {
    return r >= 0 && strip_smem(r, mode, dt, strip_band_rows(mode)) <= kMaxSmem &&
           strip_cols(r) <= 32 * 32;
}

// pre[0] = 0 and pre[i + 1] = flag[0] + .. + flag[i] for i < n, by the
// calling warp: a shuffle scan of 32 flags at a time.
__device__ __forceinline__ void warp_prefix_counts(const uint8_t* flag, int* pre, int n) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) pre[0] = 0;
    int carry = 0;
    for (int base = 0; base < n; base += 32) {
        int v = base + lane < n ? flag[base + lane] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (base + lane < n) pre[base + lane + 1] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
    }
}

// grid (ceil(W / kStripW), ceil(H / band), N), block kStripThreads,
// strip_smem(r, kMode, kDt, band) bytes. kMode kDark: (N, H, W, 3) -> the
// channel min, then the windowed min (+inf off the frame); kMin: (N, H, W)
// -> the windowed min (+inf off the frame), its runs min_run's; kMean:
// (N, H, W) -> the windowed mean over the clipped window; kMaskedMin and
// kMaskedMean the same with the (H,) / (W,) validity bytes vh / vw (0 =
// invalid), an invalid pixel taken as one off the frame, and the mean
// divided by max(rowcnt * colcnt, 1) of the valid rows and columns. kDt: 0
// float32, 1 bfloat16, in and out. A block walks down its input rows (its
// band and r above and below) a piece of kPieceRows rows at a time, into
// float32 rows with the fill off the frame (see the head of this file for
// how each form fills them); the horizontal windows of a piece's rows, a
// warp's lanes on its 32 rows, a run of kRunX outputs a thread, go into the
// band's horizontal sums; last the vertical windows of the band's outputs,
// a run of kRunY a thread, straight to out. Each sum adds its terms in
// ascending order from +0, horizontal then vertical, and the mean divides
// once by the count: the terms, order and division of window_kernel<kMean>
// (<kMaskedMean>), with +0 for each term off the frame (or invalid), which
// leaves a sum from +0 unchanged bit for bit.
//
// The masked forms take the mask where the pieces are staged, never per
// tap: an invalid column of a piece is the fill (the sum's a zero-filled
// copy, which reads nothing; the min's a stored +inf) and an invalid row
// takes no runs, its horizontal results the fill, so an invalid pixel's
// value (+-inf or NaN from upstream) is never read into an operation. The
// block takes its input columns' and rows' validity bytes into shared
// memory once, and each lane its columns' validity into the bits of one
// register, which its copies test. A block whose input columns and rows
// are all valid (an interior block, every block of an unsharded plane)
// skips the mask: the rest of the kernel is compiled twice, and such a
// block runs the unmasked strips' code with the closed-form counts, not
// code that tests a runtime flag at every row and count. In a masked
// block warps 0 and 1 take the prefix counts of its valid columns and
// rows while the first copies fly, and each output's counts are two
// differences of them.
template <int kMode, int kDt>
__global__ void __launch_bounds__(kStripThreads)
strip_window_kernel(const void* __restrict__ x, void* __restrict__ out, int H, int W, int r,
                    int band, const uint8_t* __restrict__ vh,
                    const uint8_t* __restrict__ vw) {
    constexpr bool kSum = kMode == kMean || kMode == kMaskedMean;
    constexpr bool kVanHerk = kMode == kMin || kMode == kMaskedMin;
    constexpr bool kMasked = strip_masked(kMode);
    constexpr bool kDirect = strip_direct(kMode, kDt);
    constexpr int kWarps = kStripThreads / 32;
    extern __shared__ __align__(16) uint8_t smem[];
    const float fill = kSum ? 0.0f : INFINITY;
    const int cols = static_cast<int>(strip_cols(r)), fstride = cols | 1;
    const int piece_floats = kPieceRows * fstride;
    // flt[kPieceRows][fstride] (kDirect: two), then
    // hsum[band + 2r + kRunY - 1][kSumStride]; the masked forms then
    // ccnt[cols + 1], rcnt[band + 2r + 1] (int) and cflag[cols],
    // rflag[band + 2r] (bytes).
    float* flt = reinterpret_cast<float*>(smem);
    float* hsum = flt + (kDirect ? 2 : 1) * piece_floats;
    int* ccnt = reinterpret_cast<int*>(hsum + (band + 2 * r + kRunY - 1) * kSumStride);
    int* rcnt = ccnt + cols + 1;
    uint8_t* cflag = reinterpret_cast<uint8_t*>(rcnt + band + 2 * r + 1);
    uint8_t* rflag = cflag + cols;
    const int x0 = blockIdx.x * kStripW, xf = x0 - r;   // first output, first input column
    const int y0 = blockIdx.y * band, rows_out = min(band, H - y0);
    const int need = rows_out + 2 * r;           // input rows, from y0 - r
    const int pieces = (need + kPieceRows - 1) / kPieceRows;
    const long long frame = static_cast<long long>(blockIdx.z) * H * W;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // The mask: the validity of the strip's input columns and the band's
    // input rows (0 off the frame), and whether any in the frame is invalid.
    bool any_invalid = false;
    if constexpr (kMasked) {
        bool all = true;
        for (int j = threadIdx.x; j < cols; j += kStripThreads) {
            const int xx = xf + j;
            const bool in = xx >= 0 && xx < W;
            const bool v = in && vw[xx] != 0;
            all = all && v == in;
            cflag[j] = v;
        }
        for (int i = threadIdx.x; i < need; i += kStripThreads) {
            const int y = y0 - r + i;
            const bool in = y >= 0 && y < H;
            const bool v = in && vh[y] != 0;
            all = all && v == in;
            rflag[i] = v;
        }
        any_invalid = !__syncthreads_and(all);   // and the flags are in
    }
    // The rest, compiled twice for the masked forms (masked: some input
    // column or row of the block invalid), so that the other blocks run
    // the unmasked strips' code.
    auto body = [&](auto masked_v) {
        constexpr bool masked = decltype(masked_v)::value;
        // Whether input row i of the band is in the frame and valid; bit m
        // of cbits whether the lane's input column j = lane + 32 m of the
        // strip is (taken once: a piece's copies test a register, not the
        // flags).
        auto row_in = [&](int i) {
            const int y = y0 - r + i;
            return y >= 0 && y < H && (!masked || rflag[i]);
        };
        uint32_t cbits = 0;
        for (int m = 0, j = lane; j < cols; ++m, j += 32) {
            const int xx = xf + j;
            cbits |= (xx >= 0 && xx < W && (!masked || cflag[j]) ? 1u : 0u) << m;
        }

        // kDirect: starts the copies of piece p's rows that lie in the
        // frame (and are valid) into buffer p & 1, their columns off it (or
        // invalid) the fill (the sums' zeros by the copies, the minima's
        // +inf by stores).
        auto stage = [&](int p) {
            if (p >= pieces) return;
            for (int i = warp; i < kPieceRows; i += kWarps) {
                const int rel = p * kPieceRows + i, y = y0 - r + rel;
                if (rel >= need || !row_in(rel)) continue;
                const float* src =
                    static_cast<const float*>(x) + frame + static_cast<long long>(y) * W;
                float* dst = flt + (p & 1) * piece_floats + i * fstride;
                for (int m = 0, j = lane; j < cols; ++m, j += 32) {
                    const bool in = (cbits >> m) & 1u;
                    if (kSum || in) cp_async4(dst + j, in ? src + xf + j : src, in ? 4 : 0);
                    else dst[j] = INFINITY;
                }
            }
        };

        if constexpr (kDirect) {
            stage(0);
            cp_async_commit();
            stage(1);
            cp_async_commit();
        }
        if (masked) {                            // read after the pieces' barriers
            if (warp == 0) warp_prefix_counts(cflag, ccnt, cols);
            if (warp == 1) warp_prefix_counts(rflag, rcnt, need);
        }
        for (int p = 0; p < pieces; ++p) {
            if constexpr (kDirect) cp_async_wait_group<1>();   // piece p landed
            __syncthreads();                     // and every thread's copies; flt read
            const float* piece = flt + (kDirect ? (p & 1) * piece_floats : 0);
            if constexpr (!kDirect) {
                // Piece p in float32 from device memory: a warp a row, its
                // lanes along it; the loads of a warp's rows do not wait on
                // each other.
#pragma unroll
                for (int i = warp; i < kPieceRows; i += kWarps) {
                    const int rel = p * kPieceRows + i, y = y0 - r + rel;
                    if (rel >= need || !row_in(rel)) continue;   // no runs
                    const long long row = frame + static_cast<long long>(y) * W;
                    float* dst = flt + i * fstride;
#pragma unroll 4
                    for (int m = 0, j = lane; j < cols; ++m, j += 32) {
                        const bool in = (cbits >> m) & 1u;
                        const long long e = row + (in ? xf + j : 0);
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
            const int rel = p * kPieceRows + lane, c0 = warp * kRunX;
            if (rel < need) {
                float s[1][kRunX];
                if (row_in(rel)) {
                    const float* src = piece + lane * fstride + c0;
                    if constexpr (kVanHerk)
                        min_run<kRunX>([&](int k) { return src[k]; }, 2 * r, s[0]);
                    else
                        window_run<1, kRunX, kSum>(
                            [&](int k, float (&v)[1]) { v[0] = src[k]; }, 2 * r, s);
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

        // The vertical runs: a warp's lanes are adjacent columns; output row
        // o's window is input rows o .. o + 2r counted from y0 - r, output
        // column c's input columns c .. c + 2r counted from xf.
        const int c = threadIdx.x % kStripW, xo = x0 + c;
        const float cnt_x = static_cast<float>(masked ? ccnt[c + 2 * r + 1] - ccnt[c]
                                                      : win_count(xo, W, r));
        for (int o0 = (threadIdx.x / kStripW) * kRunY; o0 < rows_out;
             o0 += kRunY * (kStripThreads / kStripW)) {
            const float* src = hsum + o0 * kSumStride + c;
            float s[1][kRunY];
            if constexpr (kVanHerk)
                min_run<kRunY>([&](int k) { return src[k * kSumStride]; }, 2 * r, s[0]);
            else
                window_run<1, kRunY, kSum>(
                    [&](int k, float (&v)[1]) { v[0] = src[k * kSumStride]; }, 2 * r, s);
            if (xo >= W) continue;
#pragma unroll
            for (int q = 0; q < kRunY; ++q) {
                const int o = o0 + q, y = y0 + o;
                if (o >= rows_out) continue;         // past the band: not stored
                float v = s[0][q];
                if constexpr (kSum) {
                    const float cnt_y = static_cast<float>(
                        masked ? rcnt[o + 2 * r + 1] - rcnt[o] : win_count(y, H, r));
                    v = kMasked ? __fdiv_rn(v, fmaxf(__fmul_rn(cnt_y, cnt_x), 1.0f))
                                : __fdiv_rn(v, __fmul_rn(cnt_y, cnt_x));
                }
                store_px(out, frame + static_cast<long long>(y) * W + xo, kDt, v);
            }
        }
    };
    if (kMasked && any_invalid) body(std::true_type{});
    else body(std::false_type{});
}

// Whether a tile of `count` pixels at `first` takes load_tile: whole (of
// kTop1Threads * kItems pixels) and aligned to 4 pixels (16 bytes of
// float32, 8 of bfloat16).
template <int kItems>
__device__ __forceinline__ bool tile_vector(const char* first, long long count, int t_dt) {
    static_assert(kItems % 4 == 0, "whole 4-pixel vector loads");
    return count == kTop1Threads * kItems &&
           reinterpret_cast<uintptr_t>(first) % (t_dt == 0 ? 16 : 8) == 0;
}

// The calling thread's pixels of such a tile, every load in flight first
// (kLoads = kItems / 4 of them): v[j][c] = pixel 4 (j * kTop1Threads +
// threadIdx.x) + c.
template <int kLoads>
__device__ __forceinline__ void load_tile(const char* first, int t_dt, float (&v)[kLoads][4]) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
        const int q = j * kTop1Threads + threadIdx.x;
        if (t_dt == 0) {
            const float4 f = reinterpret_cast<const float4*>(first)[q];
            v[j][0] = f.x;
            v[j][1] = f.y;
            v[j][2] = f.z;
            v[j][3] = f.w;
        } else {                                 // bfloat16 widens by a shift
            const uint2 u = reinterpret_cast<const uint2*>(first)[q];
            v[j][0] = __uint_as_float(u.x << 16);
            v[j][1] = __uint_as_float(u.x & 0xffff0000u);
            v[j][2] = __uint_as_float(u.y << 16);
            v[j][3] = __uint_as_float(u.y & 0xffff0000u);
        }
    }
}

// grid (tiles, N), block kTop1Threads: keys[n * tiles + j] = the smallest
// key of pixels [j * tile, (j + 1) * tile) of frame n of t (P pixels a
// frame, t_dt), tile = kTop1Threads * kItems.
template <int kItems>
__global__ void __launch_bounds__(kTop1Threads)
top1_tile_kernel(const void* __restrict__ t, int t_dt, unsigned long long* __restrict__ keys,
                 long long P) {
    constexpr int kTile = kTop1Threads * kItems, kLoads = kItems / 4;
    __shared__ unsigned long long red[kTop1Threads / 32 + 1];
    const long long n = blockIdx.y;
    const long long start = static_cast<long long>(blockIdx.x) * kTile;
    const long long count = min(static_cast<long long>(kTile), P - start);
    const long long base = n * P + start;        // element of the tile's first pixel
    const char* first = static_cast<const char*>(t) + base * (t_dt == 0 ? 4 : 2);
    unsigned long long best = kNoKey;
    if (tile_vector<kItems>(first, count, t_dt)) {
        float v[kLoads][4];
        load_tile(first, t_dt, v);
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

// ---------------------------------------------------------------------------
// Warp top-k (B6b st_atmolight_topk, 1 <= k <= kWarpTopkMax): a grid of
// kTop1Tile-pixel tiles as the top-1 light's, each lane keeping the K >= k
// smallest keys of its pixels in registers, then one warp a frame.
// ---------------------------------------------------------------------------

constexpr int kWarpTopkMax = 16;                 // the largest k of the warp top-k

// The high word of make_key: t's order-preserving bits (-0.0 as +0.0).
__device__ __forceinline__ unsigned key_hi(float t) {
    return static_cast<unsigned>(make_key(t, 0u) >> 32);
}

// A lane's K smallest keys of those given it, ascending (kNoKey where it
// was given fewer), in registers as high and low words (32-bit compares
// and selects where the order allows): K is a compile-time size.
template <int K>
struct KeyList {
    unsigned hi[K], lo[K];

    __device__ __forceinline__ KeyList() {
#pragma unroll
        for (int i = 0; i < K; ++i) hi[i] = lo[i] = 0xffffffffu;
    }

    __device__ __forceinline__ static bool less(unsigned h, unsigned l, unsigned eh, unsigned el) {
        return (static_cast<unsigned long long>(h) << 32 | l) <
               (static_cast<unsigned long long>(eh) << 32 | el);
    }

    // Any key, without a branch: entry i becomes entry i - 1 where the key
    // is below it, else the key where it is below entry i, else stays (the
    // largest falls off).
    __device__ __forceinline__ void insert(unsigned long long key) {
        const unsigned h = static_cast<unsigned>(key >> 32), l = static_cast<unsigned>(key);
#pragma unroll
        for (int i = K - 1; i > 0; --i) {
            const bool c1 = less(h, l, hi[i - 1], lo[i - 1]), c0 = less(h, l, hi[i], lo[i]);
            hi[i] = c1 ? hi[i - 1] : c0 ? h : hi[i];
            lo[i] = c1 ? lo[i - 1] : c0 ? l : lo[i];
        }
        const bool c0 = less(h, l, hi[0], lo[0]);
        hi[0] = c0 ? h : hi[0];
        lo[0] = c0 ? l : lo[0];
    }

    // The same for the filled-th key given this list (a compile-time count
    // once unrolled; entries from `filled` on are empty) whose index is
    // above every key's given before: a tie in t goes after the entries, so
    // the high words alone decide, 32-bit compares.
    __device__ __forceinline__ void insert_after(unsigned h, unsigned l, int filled) {
#pragma unroll
        for (int i = K - 1; i > 0; --i) {
            if (i > filled) continue;            // stays empty
            const bool c1 = h < hi[i - 1], c0 = i == filled || h < hi[i];
            hi[i] = c1 ? hi[i - 1] : c0 ? h : hi[i];
            lo[i] = c1 ? lo[i - 1] : c0 ? l : lo[i];
        }
        const bool c0 = filled == 0 || h < hi[0];
        hi[0] = c0 ? h : hi[0];
        lo[0] = c0 ? l : lo[0];
    }

    // The calling warp's k <= K smallest keys over every lane's list,
    // ascending: k rounds of a warp minimum over the lanes' heads (two
    // 32-bit warp reductions, high word then low word), the lane that holds
    // it (keys are unique: the low word is the index) popping its head.
    // take(s, m) runs in every lane with the s-th smallest, s a
    // compile-time index once unrolled.
    template <class Take>
    __device__ __forceinline__ void warp_take(int k, const Take& take) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
            if (s >= k) break;
            const unsigned mh = __reduce_min_sync(0xffffffffu, hi[0]);
            const unsigned ml = __reduce_min_sync(0xffffffffu, hi[0] == mh ? lo[0] : 0xffffffffu);
            if (hi[0] == mh && lo[0] == ml) {
#pragma unroll
                for (int i = 0; i < K - 1; ++i) {
                    hi[i] = hi[i + 1];
                    lo[i] = lo[i + 1];
                }
                hi[K - 1] = lo[K - 1] = 0xffffffffu;
            }
            take(s, static_cast<unsigned long long>(mh) << 32 | ml);
        }
    }
};

// grid (tiles, N), block kTop1Threads: lists[(n * tiles + j) * k + s] = the
// s-th smallest key of pixels [j * tile, (j + 1) * tile) of frame n of t (P
// pixels a frame, t_dt, tile = kTop1Threads * kItems), kNoKey past the
// tile's pixels; k <= K.
// The loads are top1_tile_kernel's (load_tile); each lane keeps its
// pixels' K smallest keys (its 16 pixels arrive in index order, so by
// insert_after), each warp takes its k smallest from its lanes' lists, and
// warp 0 the tile's from the warps': one barrier a tile, not 2k.
template <int K, int kItems>
__global__ void __launch_bounds__(kTop1Threads)
topk_tile_kernel(const void* __restrict__ t, int t_dt, unsigned long long* __restrict__ lists,
                 long long P, int k) {
    constexpr int kWarps = kTop1Threads / 32;
    constexpr int kTile = kTop1Threads * kItems, kLoads = kItems / 4;
    __shared__ unsigned long long warp_keys[kWarps * K];
    const long long n = blockIdx.y;
    const long long start = static_cast<long long>(blockIdx.x) * kTile;
    const long long count = min(static_cast<long long>(kTile), P - start);
    const long long base = n * P + start;
    const char* first = static_cast<const char*>(t) + base * (t_dt == 0 ? 4 : 2);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    KeyList<K> mine;
    if (tile_vector<kItems>(first, count, t_dt)) {
        float v[kLoads][4];
        load_tile(first, t_dt, v);
        const unsigned i0 = static_cast<unsigned>(start) + 4u * threadIdx.x;
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                mine.insert_after(key_hi(v[j][c]), i0 + 4u * (j * kTop1Threads) + c, 4 * j + c);
    } else {
        for (long long i = threadIdx.x; i < count; i += kTop1Threads)
            mine.insert(make_key(load_px(t, base + i, t_dt, 1.0f),
                                 static_cast<unsigned>(start + i)));
    }
    mine.warp_take(k, [&](int s, unsigned long long m) {
        if (lane == 0) warp_keys[warp * k + s] = m;
    });
    __syncthreads();
    if (warp != 0) return;
    KeyList<K> tile;
    for (int i = lane; i < kWarps * k; i += 32) tile.insert(warp_keys[i]);
    unsigned long long* out = lists + (n * gridDim.x + blockIdx.x) * k;
    tile.warp_take(k, [&](int s, unsigned long long m) {
        if (lane == 0) out[s] = m;
    });
}

// grid (N,), one warp a block: out[n] (img_dt) = the mean of img over the
// k <= K smallest keys of frame n's n_keys tile-list keys, its rgb summed
// in ascending key order with RgbSum's compensated sum (lane q channel q),
// so it equals topk_merge_kernel's output bit for bit.
template <int K>
__global__ void topk_gather_kernel(const unsigned long long* __restrict__ lists, int n_keys,
                                   int k, const void* __restrict__ img, int img_dt, long long P,
                                   void* __restrict__ out) {
    const long long n = blockIdx.x;
    const int lane = threadIdx.x;
    const unsigned long long* keys = lists + n * n_keys;
    KeyList<K> mine;
    constexpr int kBatch = 8;                    // keys a lane loads before it inserts them
    for (int i0 = lane; i0 < n_keys; i0 += 32 * kBatch) {
        unsigned long long b[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int i = i0 + 32 * q;
            b[q] = i < n_keys ? keys[i] : kNoKey;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) mine.insert(b[q]);
    }
    long long px[K];
    mine.warp_take(k, [&](int s, unsigned long long m) {
        px[s] = n * P + static_cast<long long>(m & 0xffffffffULL);
    });
    if (lane >= 3) return;
    float v[K];
#pragma unroll
    for (int s = 0; s < K; ++s)                  // every load in flight first
        if (s < k) v[s] = load_px(img, 3 * px[s] + lane, img_dt, 1.0f);
    float sum = 0.0f, c = 0.0f;
#pragma unroll
    for (int s = 0; s < K; ++s)
        if (s < k) comp_add(sum, c, v[s]);
    store_px(out, 3 * n + lane, img_dt, __fdiv_rn(__fadd_rn(sum, c), static_cast<float>(k)));
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

// grid (L,), block 32 (M = 1) or 32 * kMergeEmaWarps, dynamic shared
// memory kMergeEmaWarps * k ints at M > 1. Lane l: frames n = l*B + b with
// ids[n] (< 0 padding) and M rows each (t, gidx unread at M = 1); the state
// (A (L, 3), last_update (L,), initialized (L,) bytes) in, a_seq (L, B, 3)
// and the new state out. The state out may be the state in (a donated
// state): each lane reads its row before it writes it. At M > 1 a_seq
// holds the candidates until the EMA overwrites each with its A.
__global__ void merge_ema_kernel(const float* __restrict__ t, const int* __restrict__ gidx,
                                 const float* __restrict__ rgb, const int* __restrict__ ids,
                                 const float* A_in, const int* lu_in, const uint8_t* init_in,
                                 float* a_seq, float* A_out, int* lu_out, uint8_t* init_out,
                                 int B, int M, int k, int period, float lam,
                                 float one_minus_lam, int associative) {
    extern __shared__ int sel[];                 // [kMergeEmaWarps][k]
    const int l = blockIdx.x;
    const long long base = static_cast<long long>(l) * B;
    float* out = a_seq + 3 * base;
    if (M > 1) {
        const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
        int* sw = sel + warp * k;
        for (int b = warp; b < B; b += kMergeEmaWarps) {
            const long long n = base + b;
            const float* tn = t + n * M;
            const int* gn = gidx + n * M;
            for (int i = ln; i < M; i += 32) {
                const unsigned long long key =
                    make_key(tn[i], static_cast<unsigned>(gn[i]) ^ 0x80000000u);
                int rank = 0;
                for (int j = 0; j < M && rank < k; ++j) {
                    const unsigned long long other =
                        make_key(tn[j], static_cast<unsigned>(gn[j]) ^ 0x80000000u);
                    rank += (other < key || (other == key && j < i)) ? 1 : 0;
                }
                if (rank < k) sw[rank] = i;      // ranks are distinct
            }
            __syncwarp();
            if (ln < 3) {                        // one channel a lane
                float s = 0.0f, c = 0.0f;
                for (int q = 0; q < k; ++q) comp_add(s, c, rgb[3 * (n * M + sw[q]) + ln]);
                out[3 * b + ln] = __fdiv_rn(__fadd_rn(s, c), static_cast<float>(k));
            }
            __syncwarp();                        // sw[] read before the next frame
        }
        __syncthreads();                         // every candidate in a_seq
    }
    if (threadIdx.x != 0) return;
    const float* cand = M > 1 ? out : rgb + 3 * base;
    const int* id = ids + base;
    const float A0[3] = {A_in[3 * l], A_in[3 * l + 1], A_in[3 * l + 2]};
    const int k0 = lu_in[l];
    const int inited0 = init_in[l] != 0 ? 1 : 0;
    if (!associative) {
        float A[3] = {A0[0], A0[1], A0[2]};
        int kk = k0, inited = inited0;
        for (int b = 0; b < B; ++b) {
            const float cv[3] = {cand[3 * b], cand[3 * b + 1], cand[3 * b + 2]};
            ema_step(A, kk, inited, cv, id[b], out + 3 * b, period, lam, one_minus_lam);
        }
        for (int q = 0; q < 3; ++q) A_out[3 * l + q] = A[q];
        lu_out[l] = kk;
        init_out[l] = static_cast<uint8_t>(inited);
        return;
    }
    int first = 0;                               // argmax of valid: 0 if none
    while (first < B && id[first] < 0) ++first;
    if (first == B) first = 0;
    const int fid0 = id[first];
    // int32 sums and differences wrap, as in the reference.
    const int after = static_cast<int>(static_cast<unsigned>(k0) + static_cast<unsigned>(period));
    const int u0 = inited0 ? max(fid0, after) : fid0;
    float cc = 0.0f, dd[3] = {0.0f, 0.0f, 0.0f};
    int last = kBootstrapId;
    bool any_upd = false, any_valid = false;
    for (int b = 0; b < B; ++b) {
        const int fid = id[b];
        const bool valid = fid >= 0;
        const int d = static_cast<int>(static_cast<unsigned>(fid) - static_cast<unsigned>(u0));
        const bool mask = valid && d >= 0 && d % period == 0;
        const bool boot = !inited0 && valid && b == first;
        const float lm = __fmul_rn(lam, mask ? 1.0f : 0.0f);
        const float c = boot ? 0.0f : __fsub_rn(1.0f, lm);
        float dv[3];
        for (int q = 0; q < 3; ++q) dv[q] = boot ? cand[3 * b + q] : __fmul_rn(lm, cand[3 * b + q]);
        if (b == 0) {
            cc = c;
            for (int q = 0; q < 3; ++q) dd[q] = dv[q];
        } else {
            cc = __fmul_rn(c, cc);
            for (int q = 0; q < 3; ++q) dd[q] = __fadd_rn(__fmul_rn(c, dd[q]), dv[q]);
        }
        for (int q = 0; q < 3; ++q) out[3 * b + q] = __fadd_rn(__fmul_rn(cc, A0[q]), dd[q]);
        if (mask || boot) {
            last = max(last, fid);
            any_upd = true;
        }
        any_valid = any_valid || valid;
    }
    for (int q = 0; q < 3; ++q) A_out[3 * l + q] = out[3 * (B - 1) + q];
    lu_out[l] = any_upd ? last : k0;
    init_out[l] = static_cast<uint8_t>(inited0 || any_valid ? 1 : 0);
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

template <int K, int kItems>
int launch_warp_topk(const void* img, const void* t, unsigned long long* lists, void* out,
                     int N, long long P, int k, int img_dt, int t_dt, cudaStream_t s) {
    constexpr int kTile = kTop1Threads * kItems;
    const int tiles = static_cast<int>((P + kTile - 1) / kTile);
    topk_tile_kernel<K, kItems><<<dim3(tiles, N), kTop1Threads, 0, s>>>(t, t_dt, lists, P, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    topk_gather_kernel<K><<<N, 32, 0, s>>>(lists, tiles * k, k, img, img_dt, P, out);
    return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, kItems>{}) for B6a's and B6b's tile of
// `tile` pixels: 2048, 4096 or 8192 (8, 16 or 32 pixels a thread);
// cudaErrorInvalidValue, calling nothing, for any other.
template <class F>
int with_top1_items(int tile, const F& f) {
    if (tile == kTop1Threads * 8) return f(std::integral_constant<int, 8>{});
    if (tile == kTop1Threads * 16) return f(std::integral_constant<int, 16>{});
    if (tile == kTop1Threads * 32) return f(std::integral_constant<int, 32>{});
    return static_cast<int>(cudaErrorInvalidValue);
}

// f(std::integral_constant<int, K>{}) for the warp top-k's list size K of
// k: the next of 2, 4, 8, 16 (kWarpTopkMax).
template <class F>
int with_list_size(int k, const F& f) {
    static_assert(kWarpTopkMax == 16, "the largest list takes k = kWarpTopkMax");
    if (k <= 2) return f(std::integral_constant<int, 2>{});
    if (k <= 4) return f(std::integral_constant<int, 4>{});
    if (k <= 8) return f(std::integral_constant<int, 8>{});
    return f(std::integral_constant<int, 16>{});
}

template <int kMode, int kDt>
int launch_strips(const void* x, void* out, int N, int H, int W, int r, void* stream,
                  const uint8_t* vh, const uint8_t* vw) {
    int band = 0;
    cudaError_t e;
    const size_t smem = strips_opt_in<kMode, kDt>(H, r, band, e);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((W + kStripW - 1) / kStripW, (H + band - 1) / band, N);
    strip_window_kernel<kMode, kDt><<<grid, kStripThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        x, out, H, W, r, band, vh, vw);
    return static_cast<int>(cudaGetLastError());
}

// vh and vw: the masked forms' validity bytes (read by those only).
template <int kMode>
int launch_strips(const void* x, void* out, int N, int H, int W, int r, int dt,
                  void* stream, const uint8_t* vh = nullptr, const uint8_t* vw = nullptr) {
    return dt == 0 ? launch_strips<kMode, 0>(x, out, N, H, W, r, stream, vh, vw)
                   : launch_strips<kMode, 1>(x, out, N, H, W, r, stream, vh, vw);
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

// The window mode of a strip kind: 0 the box filter, 1 the dark channel,
// 2 the min filter, 3 the masked box filter, 4 the masked min filter.
int strip_mode(int kind) {
    switch (kind) {
        case 1: return kDark;
        case 2: return kMin;
        case 3: return kMaskedMean;
        case 4: return kMaskedMin;
        default: return kMean;
    }
}

// f(std::integral_constant<int, mode>{}) for a window mode.
template <class F>
int with_mode(int mode, const F& f) {
    switch (mode) {
        case kDark: return f(std::integral_constant<int, kDark>{});
        case kMin: return f(std::integral_constant<int, kMin>{});
        case kMaskedMean: return f(std::integral_constant<int, kMaskedMean>{});
        case kMaskedMin: return f(std::integral_constant<int, kMaskedMin>{});
        default: return f(std::integral_constant<int, kMean>{});
    }
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
int st_min_band_rows() { return kMinBandRows; }
int st_warp_topk_max() { return kWarpTopkMax; }
int st_merge_ema_max_k() { return kMergeEmaMaxK; }

// 1 where the strips take the box filter (kind 0), the dark channel (1),
// the min filter (2), the masked box filter (3) or the masked min filter
// (4) at this radius and dtype, else 0.
int st_strips_fit(int kind, int radius, int dt) {
    return strips_fit(strip_mode(kind), radius, dt) ? 1 : 0;
}

// *blocks = blocks an SM of the strips of a kind (as st_strips_fit) on
// frames of H rows at this radius and dtype.
int st_strips_occupancy(int kind, int radius, int dt, int H, int* blocks) {
    return with_mode(strip_mode(kind), [&](auto M) {
        constexpr int kMode = decltype(M)::value;
        return dt == 0 ? strips_occupancy<kMode, 0>(H, radius, blocks)
                       : strips_occupancy<kMode, 1>(H, radius, blocks);
    });
}

// *blocks = blocks an SM of the row window (window_kernel) of a kind (as
// st_strips_fit) on frames of H rows at this radius.
int st_window_occupancy(int kind, int radius, int H, int* blocks) {
    const size_t smem = static_cast<size_t>(min(kTileY + 2 * radius, H)) * kTileX * sizeof(float);
    if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
    return with_mode(strip_mode(kind), [&](auto M) {
        const auto kernel = window_kernel<decltype(M)::value>;
        cudaError_t e = cudaSuccess;
        if (smem > 48 * 1024)
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                              kTileX * kRowThreads, smem);
        return static_cast<int>(e);
    });
}

// *blocks = blocks an SM of the top-k light's tile kernel at k: the warp
// top-k's topk_tile_kernel for k <= st_warp_topk_max(), else
// topk_block_kernel.
int st_topk_occupancy(int k, int* blocks) {
    if (k < 1 || k > kWarpTopkMax)
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, topk_block_kernel, kTopkThreads, 0));
    return with_list_size(k, [&](auto K) {
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, topk_tile_kernel<decltype(K)::value, kTop1Items>, kTop1Threads, 0));
    });
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

// (N, H, W) -> (N, H, W), both in dt: the strips, where
// st_strips_fit(2, radius, dt).
int st_min_filter(const void* x, void* out, int N, int H, int W, int radius, int dt,
                  void* stream) {
    return launch_strips<kMin>(x, out, N, H, W, radius, dt, stream);
}

// The same by window_kernel, for radii the strips do not take.
int st_min_filter_wide(const void* x, void* out, int N, int H, int W, int radius, int dt,
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
// windowed min with invalid pixels +inf: the strips, where
// st_strips_fit(4, radius, dt).
int st_masked_min_filter(const void* x, const uint8_t* vh, const uint8_t* vw,
                         void* out, int N, int H, int W, int radius, int dt,
                         void* stream) {
    return launch_strips<kMaskedMin>(x, out, N, H, W, radius, dt, stream, vh, vw);
}

// The same by window_kernel, for radii the strips do not take.
int st_masked_min_filter_wide(const void* x, const uint8_t* vh, const uint8_t* vw,
                              void* out, int N, int H, int W, int radius, int dt,
                              void* stream) {
    return launch_window<kMaskedMin>(x, out, N, H, W, radius, dt, stream, vh, vw);
}

// (N, H, W) in dt, (H,) and (W,) validity bytes -> (N, H, W) in dt, the
// windowed mean over the valid pixels (0 where a window has none): the
// strips, where st_strips_fit(3, radius, dt).
int st_masked_box_filter(const void* x, const uint8_t* vh, const uint8_t* vw,
                         void* out, int N, int H, int W, int radius, int dt,
                         void* stream) {
    return launch_strips<kMaskedMean>(x, out, N, H, W, radius, dt, stream, vh, vw);
}

// The same by window_kernel, for radii the strips do not take.
int st_masked_box_filter_wide(const void* x, const uint8_t* vh, const uint8_t* vw,
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

// Per lane l < L: (B, M) float32 t and int32 global index (unread at
// M = 1), (B, M, 3) float32 rgb, (B,) int32 ids (< 0 padding) and the
// state row (A float32 x 3, last_update int32, initialized byte) -> a_seq
// (B, 3) float32 (the A of each frame after Eq. 9) and the new state row
// (which may be the state row read). Each frame's candidate is the mean rgb
// of its k smallest (t, index) rows, 1 <= k <= min(M, st_merge_ema_max_k());
// the scan is sequential or, where associative != 0, the associative
// scan's order of operations; period >= 1.
int st_merge_ema(const float* t, const int* gidx, const float* rgb, const int* ids,
                 const float* A_in, const int* lu_in, const uint8_t* init_in, float* a_seq,
                 float* A_out, int* lu_out, uint8_t* init_out, int L, int B, int M, int k,
                 int period, float lam, float one_minus_lam, int associative, void* stream) {
    if (L < 1 || B < 1 || k < 1 || k > M || k > kMergeEmaMaxK || period < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = M > 1 ? 32 * kMergeEmaWarps : 32;
    const size_t smem = M > 1 ? static_cast<size_t>(kMergeEmaWarps) * k * sizeof(int) : 0;
    merge_ema_kernel<<<L, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        t, gidx, rgb, ids, A_in, lu_in, init_in, a_seq, A_out, lu_out, init_out, B, M, k,
        period, lam, one_minus_lam, associative);
    return static_cast<int>(cudaGetLastError());
}

// (N, H, W, 3) img_dt, (N, H, W) t_dt -> (N, 3) img_dt, I at the smallest
// (t, flat index) key of each frame, over tiles of tile_pixels (2048, 4096
// = st_top1_tile() or 8192; cudaErrorInvalidValue for another); keys is
// scratch for N x ceil(H*W / tile_pixels) keys.
int st_atmolight(const void* img, const void* t, unsigned long long* keys, void* out,
                 int N, int H, int W, int img_dt, int t_dt, int tile_pixels, void* stream) {
    const long long P = static_cast<long long>(H) * W;
    const int tiles = static_cast<int>((P + tile_pixels - 1) / tile_pixels);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return with_top1_items(tile_pixels, [&](auto items) {
        top1_tile_kernel<decltype(items)::value><<<dim3(tiles, N), kTop1Threads, 0, s>>>(
            t, t_dt, keys, P);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        top1_gather_kernel<<<N, 32, 0, s>>>(keys, tiles, img, out, P, img_dt);
        return static_cast<int>(cudaGetLastError());
    });
}

// (N, H, W, 3) img_dt, (N, H, W) t_dt -> (N, 3) img_dt, the mean of I over
// the k smallest (t, flat index) keys of each frame, 1 <= k <= min(H*W,
// st_warp_topk_max()), by the warp top-k over tiles of tile_pixels (as
// st_atmolight's); lists is scratch for N x ceil(H*W / tile_pixels) x k
// keys.
int st_atmolight_topk(const void* img, const void* t, unsigned long long* lists,
                      void* out, int N, int H, int W, int k, int img_dt, int t_dt,
                      int tile_pixels, void* stream) {
    const long long P = static_cast<long long>(H) * W;
    if (k < 1 || k > P || k > kWarpTopkMax) return static_cast<int>(cudaErrorInvalidValue);
    return with_top1_items(tile_pixels, [&](auto items) {
        return with_list_size(k, [&](auto K) {
            return launch_warp_topk<decltype(K)::value, decltype(items)::value>(
                img, t, lists, out, N, P, k, img_dt, t_dt, static_cast<cudaStream_t>(stream));
        });
    });
}

// The same for any 1 <= k <= H*W by the top-k kernels of dehaze_common.cuh
// (per-tile block rounds, then one block a frame); keys is scratch for N x
// ceil(H*W / st_topk_tile()) x min(k, st_topk_tile()) keys.
int st_atmolight_topk_wide(const void* img, const void* t, unsigned long long* keys,
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
