// Fused dehaze megakernel for NVIDIA Hopper (sm_90a): the whole DCP/CAP
// chain for L lanes x B frames, as four tiled passes; the same tiled passes
// without the EMA and J make the fused transmission stage (B7), and their
// masked form its halo form (B9).
//
// Replaces the TPU kernel src/repro/kernels/fused.py::fused_dehaze_lanes_pallas
// (body _fused_dehaze_kernel -> _dehaze_grid_step -> _frame_tmap,
// _guided_refine, _ema_step), and with it the function of its
// double-buffered body _fused_dehaze_dbuf_kernel (identical results).
//
// Why tiled passes, not one block per frame: the TPU kernel holds a whole
// frame in VMEM. A 480x640 float32 plane is 1.2 MB and a Hopper block has
// at most 227 KB of shared memory, so a block holds one kTileH x kTileW
// (32 x 64) output tile of one frame with the halo its windows need, and
// the chain is cut where a pass needs what other tiles computed:
//
//   fd_tmap_tile       (fused.py _frame_tmap) the tile's wire pixels with an
//                      r-halo -> pre-map (DCP min_c I/A_saved, CAP depth),
//                      luma -> vertical then horizontal windowed min ->
//                      t_raw; writes t_raw, g and, at top-1, the tile's
//                      smallest (t, flat index) key
//   fd_topk_block      (k > 1 only) the per-tile key lists of the top-k
//                      kernels in dehaze_common.cuh, over the t_raw plane
//   fd_select_ema      (the candidate of _frame_tmap, _ema_step) one block a
//                      lane: its B frames' candidates (a frame's smallest tile
//                      key at top-1, the head merge of the lists at k > 1),
//                      then Eq. 9's B steps in order
//   fd_guided_ab       (_guided_refine to a, b) g and t_raw with a gf_r-halo
//                      -> vertical sums of g, p, g*p, g*g -> horizontal sums
//                      -> means -> a, b
//   fd_refine_recover  (_guided_refine's last line, and the recovery of
//                      _dehaze_grid_step) a and b with a gf_r-halo ->
//                      vertical then horizontal sums -> refined t; J =
//                      clip((I-A)/max(t,t0)+A)^gamma with the lane's a_seq
//
// The EMA's A for frame b depends on whole-frame selections of frames <= b
// of its lane, so J cannot be made in the launch that makes t_raw without
// a barrier across the grid; the guided filter does not depend on the EMA
// (the pre-map uses the lane's batch-entry saved A), so the chain splits
// there. Device memory holds four intermediate planes (t_raw, g, a, b)
// instead of the ten-pass sequence's twelve.
//
// A tile's whole halo sits in shared memory, so the tiled passes take
// windows up to radius 36 with float32 frames (52 bfloat16, 66 uint8) and
// gf_radius 45 (fd_tiled_fits). Wider windows (He et al.'s guided filter
// uses r = 60) run the ten passes below, chosen from the static shape
// before anything launches (kernels/fused.py::fused_dehaze_lanes).
//
// The ten passes that came before stay, for those wide windows and as the
// tiled sequences' comparator on the card:
//
//   fd_premap        upcast, pre-map, luma
//   fd_min_rows      vertical windowed min of the pre-map
//   fd_min_cols_tmap horizontal windowed min, then t_raw
//   fd_topk_block    per-tile k smallest (t, flat index) keys
//   fd_topk_merge    per-frame merge of the tile lists -> candidate rgb
//                    (the top-k kernels of dehaze_common.cuh)
//   fd_ema           Eq. 9 EMA, one thread per lane, B steps in order
//   fd_box_rows4     vertical window sums of g, t_raw, g*t_raw, g*g
//   fd_box_cols_ab   horizontal sums -> means -> guided-filter a and b
//   fd_box_rows2     vertical window sums of a and b
//   fd_recover       horizontal sums -> refined t; J = clip((I-A)/max(t,t0)+A)^gamma
//   fd_tmap          (B7 only) horizontal sums -> refined t, no J
//
// The fused transmission stage of the data-parallel sharded step (B7,
// fused_transmission_pallas / fused_transmission_lanes_pallas, body
// _fused_tmap_kernel) has no EMA and no recovery (the candidates cross
// ranks first): fd_tmap_tile with the lanes' saved A, fd_topk_block at
// k > 1, fd_topk_merge on the tile keys writing the candidate in the output
// dtype with t_min, fd_guided_ab, then fd_refine_tmap, refine_recover's
// template without the wire rows and J (fd_transmission_tiled_fits; wider
// windows run the ten passes' form, ending in fd_tmap).
//
// Rounding follows the plain PyTorch version (repro_torch/kernels/ref.py)
// one operation at a time: IEEE division and expf (no fast math),
// __fmul_rn/__fadd_rn wherever a multiply-add could be contracted, uint8
// ingest multiplied by float32(1/255). So t_raw and the EMA's A are bit
// identical to it and a selection cannot flip on a 1-ulp difference.
// Window sums are direct sums over the clipped window divided by the
// closed-form in-bounds count (not cumsum differences): the guided filter
// divides var_g = corr_gg - mean_g^2 by var_g + eps, which amplifies
// summation error about 1000x. The tiled passes keep every window sum's
// order (vertical first, each output's terms in ascending order from +0)
// and pad the halo off the frame with zeros (+inf for the min) instead of
// clipping: a sum that starts at +0 is never -0, so adding a +0 leaves its
// bits alone, and the tiled sequence's J, t, a_seq and carries equal the
// ten passes' bit for bit. A thread keeps a run of outputs' sums in
// registers and fetches each input once for the run (window_run).
//
// The tuning knobs (kernels/tuning.py) change none of that: the tile (32 x
// 64 or 64 x 32, FD_TILE_H/FD_TILE_W), guided_ab's minimum blocks an SM
// (FD_GUIDED_MIN_BLOCKS) and the order of the grid's planes (lane_major)
// decide where and when an output is computed, never its terms or their
// order, and the top-1 keys are a frame's smallest over its tiles in any
// tiling; so every variant's outputs equal the default's bit for bit.
//
// What bounds it on the H100. The whole function must read 29.5 MB and
// write 118.0 MB (J) + 39.3 MB (t) = 186.8 MB at L=4, B=8, 480x640, uint8
// in and float32 out, >= 56 us at 3.35 TB/s (f32 in: 275 MB, >= 82 us).
// The direct sums bound it more: per pixel 2 (2r+1) min, 8 (2 gf_r+1) adds
// in guided_ab and 4 (2 gf_r+1) in refine_recover, about 530 float32
// operations at r = 7, gf_r = 20, 5.2 G a tick, >= 0.16 ms at the card's
// 33.5 T/s of non-FMA float32, before the vertical sums' halo columns
// (x 1.625 at a 64-column tile). Per pass at that shape (bytes over 3.35
// TB/s; direct-sum operations over 33.5 T/s):
//
//   tmap_tile       108.1 MB (0.032 ms); 47 ops/px (0.014 ms); smem 25.7 KB
//                   (uint8 in; 57.3 KB float32), a 46 x 78 halo region
//   select_ema      the keys and 3 pixels a frame: launch-bound
//   guided_ab       157.3 MB (0.047 ms); 340 ops/px (0.100 ms); smem 58.5 KB,
//                   two 72 x 104 halo planes, the runs' sums over them
//   refine_recover  304.7 MB (0.091 ms); 183 ops/px (0.054 ms); smem 73.0 KB
//                   (uint8 in), the wire and guide tiles and the a/b halo
//
// What the design does about it: the windows read shared memory, a tile's
// inputs are copied once with cp.async (16 bytes a copy where the window
// and the frame fall on 16-byte boundaries, the wire rows from the 16-byte
// boundary below their first pixel), the vertical sums overwrite the spent
// halo planes so three blocks fit an SM, and the passes are templated on
// the wire and output dtypes so the inner loops carry no dtype test. The
// TPU body's double buffering (_fused_dehaze_dbuf_kernel: the copy of the
// next frame block overlaps the compute of this one) is the occupancy
// here: three to five blocks an SM (fd_tiled_occupancy), each a tile's
// copies in flight while the others compute.
//
// The halo form (B9, src/repro/kernels/fused.py::fused_transmission_halo_pallas
// with its body _halo_grid_step, and the function of its double-buffered
// body _fused_tmap_halo_dbuf_kernel) is one spatial shard's transmission
// stage. Its inputs are the shard's core frames (N, h, w, 3) and the
// halo-extended pre-map and luma planes (N, h + 2 halo_h, w + 2 halo_w),
// float32 or bfloat16 (upcast in the kernels, no cast pass), with the row
// and column validity bytes of the exchange. There is no pre-map pass: the
// pre-map crossed the ranks. It runs the tiled passes' templates with the
// masked policy (HaloTmap, HaloGuided, HaloRefine):
//
//   fd_halo_tmap_tile      the pre-map plane staged with +inf where a pixel
//                          is invalid -> windowed min -> t_raw, on core +-
//                          2 gf_r; its core into (N, h, w); at top-1 each
//                          tile's smallest key of a core pixel (core index)
//   fd_halo_topk_block, fd_halo_topk_list (below; the list merge also takes
//                          the tile keys at top-1)
//   fd_halo_guided_ab      guide and t_raw staged with +0 where invalid ->
//                          the guided filter's sums -> a, b on core +- gf_r
//   fd_halo_refine_tmap    a, b staged with +0 where invalid -> the core's
//                          refined t in the output dtype
//
// The mask is a select at load, and the divisor, masked_count's own
// operations, comes from prefix counts of a tile's valid halo rows and
// columns taken once a tile (mask_counts). Windows too wide for a block
// (fd_halo_tiled_fits) run the ten masked passes, also the comparator:
//
//   fd_halo_min_rows       vertical windowed min, invalid pixels +inf
//   fd_halo_min_cols_tmap  horizontal windowed min, then t_raw on the whole
//                          extended plane, and its core into an (N, h, w) plane
//   fd_halo_topk_block     the top-k tiles over the core plane (local flat
//                          index, row stride w)
//   fd_halo_topk_list      the head merge writing the k ascending (t, rgb,
//                          index) rows instead of their mean
//   fd_halo_box_rows4      vertical sums of the masked g, t_raw, g*t_raw, g*g
//   fd_halo_box_cols_ab    horizontal sums -> means (divisor max(rowcnt *
//                          colcnt, 1)) -> a, b
//   fd_halo_box_rows2      vertical sums of the masked a, b
//   fd_halo_tmap           the core's refined t, clipped, in the output dtype
//
// A masked sum adds the valid terms in the order B7 adds them and skips the
// rest (the tiled form adds +0 for them), so on a tile of a frame the
// core's t_raw, t and keys are B7's on that frame bit for bit.
//
// What bounds B7 and B9 is B1's: the direct window sums (B7 at L=4, B=8,
// 480x640: 0.17 ms at 33.5 T/s) over a byte bound of 0.02 ms. B9 must read
// the core frames and both extended planes once and write t: for a 2x2
// tile of 32 uint8 frames at 480x640 (core 240x320, halo 47, float32 planes
// of 334x414) 52.6 MB, >= 16 us. Its passes cover only what the core needs:
// t_raw on core +- 2 gf_r, a and b on core +- gf_r, t on the core, 0.93,
// 0.73 and 0.56 of that tile's extended plane. A shard's planes are 414 (or
// 254) floats wide, so their copies move 8 bytes, not 16 (copy_window).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of its launches (0 on success).

#include "dehaze_common.cuh"

#include <type_traits>

extern "C" {

// Mirrors repro_torch/kernels/fused.py::_Params (ctypes.Structure).
struct DehazeParams {
    int L, B, H, W;
    int in_dtype;        // 0 float32, 1 bfloat16, 2 uint8
    int out_dtype;       // 0 float32, 1 bfloat16
    int algorithm;       // 0 dcp, 1 cap
    int radius;
    int refine;
    int gf_radius;
    int period;
    int topk;
    int lane_major;      // the tiled passes' plane order: 1 lane x B + frame, 0 frame x L + lane
    float omega, neg_beta, w0, w1, w2;
    float luma0, luma1, luma2;
    float a_floor, gf_eps, t0, gamma, lam, one_minus_lam, u8_scale;
};

// Mirrors repro_torch/kernels/fused.py::_HaloParams (ctypes.Structure).
struct HaloParams {
    int N, h, w;         // frames, core rows and columns
    int halo_h, halo_w;  // extended plane: (h + 2 halo_h) x (w + 2 halo_w)
    int in_dtype;        // img: 0 float32, 1 bfloat16, 2 uint8
    int pre_dtype;       // pre_ext: 0 float32, 1 bfloat16
    int guide_dtype;     // guide_ext: 0 float32, 1 bfloat16
    int out_dtype;       // t, tk_rgb: 0 float32, 1 bfloat16
    int algorithm;       // 0 dcp, 1 cap
    int radius;
    int refine;
    int gf_radius;
    int topk;
    float omega, neg_beta, gf_eps, u8_scale;
};

}  // extern "C"

namespace {

using namespace dehaze;

constexpr int kThreads = 256;                    // threads of a pixel pass

// The DCP pre-map's divisors: the lane's saved A, floored.
struct Divisors {
    float r, g, b;
};

__device__ __forceinline__ Divisors lane_divisors(const float* __restrict__ carry_f, int lane,
                                                  const DehazeParams& p) {
    const float* a = carry_f + 3 * lane;
    return {fmaxf(a[0], p.a_floor), fmaxf(a[1], p.a_floor), fmaxf(a[2], p.a_floor)};
}

// Pre-map of one pixel: DCP min_c I/A, CAP's depth.
__device__ __forceinline__ float premap_px(float r, float gg, float b, const Divisors& a,
                                           const DehazeParams& p) {
    if (p.algorithm == 0)
        return fminf(fminf(__fdiv_rn(r, a.r), __fdiv_rn(gg, a.g)), __fdiv_rn(b, a.b));
    const float mx = fmaxf(fmaxf(r, gg), b);
    const float mn = fminf(fminf(r, gg), b);
    const float s = mx > 0.0f ? __fdiv_rn(__fsub_rn(mx, mn), fmaxf(mx, 1e-12f)) : 0.0f;
    return __fadd_rn(__fadd_rn(p.w0, __fmul_rn(p.w1, mx)), __fmul_rn(p.w2, s));
}

__device__ __forceinline__ float luma_px(float r, float gg, float b, const DehazeParams& p) {
    return __fadd_rn(__fadd_rn(__fmul_rn(p.luma0, r), __fmul_rn(p.luma1, gg)),
                     __fmul_rn(p.luma2, b));
}

// t_raw from the windowed min of the pre-map (DehazeParams or HaloParams).
template <class Params>
__device__ __forceinline__ float tmap_of(float m, const Params& p) {
    return p.algorithm == 0 ? __fsub_rn(1.0f, __fmul_rn(p.omega, m))
                            : expf(__fmul_rn(p.neg_beta, m));
}

__global__ void premap_kernel(const void* __restrict__ img,
                              const float* __restrict__ carry_f,
                              float* __restrict__ pre, float* __restrict__ g,
                              DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const float r = load_px(img, 3 * i, p.in_dtype, p.u8_scale);
    const float gg = load_px(img, 3 * i + 1, p.in_dtype, p.u8_scale);
    const float b = load_px(img, 3 * i + 2, p.in_dtype, p.u8_scale);
    pre[i] = premap_px(r, gg, b, lane_divisors(carry_f, static_cast<int>(i / P / p.B), p), p);
    if (g != nullptr) g[i] = luma_px(r, gg, b, p);
}

__global__ void min_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                                DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int row = static_cast<int>((i % P) / p.W);
    const long long col0 = i - static_cast<long long>(row) * p.W;   // row 0, same column
    const int lo = max(row - p.radius, 0), hi = min(row + p.radius, p.H - 1);
    float m = INFINITY;
    for (int k = lo; k <= hi; ++k) m = fminf(m, x[col0 + static_cast<long long>(k) * p.W]);
    y[i] = m;
}

__global__ void min_cols_tmap_kernel(const float* __restrict__ x, float* __restrict__ t,
                                     DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int col = static_cast<int>(i % p.W);
    const long long row0 = i - col;
    const int lo = max(col - p.radius, 0), hi = min(col + p.radius, p.W - 1);
    float m = INFINITY;
    for (int k = lo; k <= hi; ++k) m = fminf(m, x[row0 + k]);
    t[i] = tmap_of(m, p);
}

// One thread per lane: B steps of Eq. 9, exactly _ema_step's semantics.
__global__ void ema_kernel(const float* __restrict__ cand, const int* __restrict__ ids,
                           const float* __restrict__ carry_f, const int* __restrict__ carry_i,
                           float* __restrict__ a_seq, float* __restrict__ carry_f_out,
                           int* __restrict__ carry_i_out, DehazeParams p) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= p.L) return;
    float A[3] = {carry_f[3 * lane], carry_f[3 * lane + 1], carry_f[3 * lane + 2]};
    int k = carry_i[2 * lane];
    int inited = carry_i[2 * lane + 1];
    for (int b = 0; b < p.B; ++b) {
        const long long n = static_cast<long long>(lane) * p.B + b;
        ema_step(A, k, inited, cand + 3 * n, ids[n], a_seq + 3 * n, p.period, p.lam,
                 p.one_minus_lam);
    }
    for (int c = 0; c < 3; ++c) carry_f_out[3 * lane + c] = A[c];
    carry_i_out[2 * lane] = k;
    carry_i_out[2 * lane + 1] = inited;
}

// Vertical window sums of g, p, g*p, g*g into four planes.
__global__ void box_rows4_kernel(const float* __restrict__ g, const float* __restrict__ t,
                                 float* __restrict__ out, DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int row = static_cast<int>((i % P) / p.W);
    const long long col0 = i - static_cast<long long>(row) * p.W;
    const int lo = max(row - p.gf_radius, 0), hi = min(row + p.gf_radius, p.H - 1);
    float s_g = 0.0f, s_p = 0.0f, s_gp = 0.0f, s_gg = 0.0f;
    for (int k = lo; k <= hi; ++k) {
        const long long j = col0 + static_cast<long long>(k) * p.W;
        const float gv = g[j], pv = t[j];
        s_g = __fadd_rn(s_g, gv);
        s_p = __fadd_rn(s_p, pv);
        s_gp = __fadd_rn(s_gp, __fmul_rn(gv, pv));
        s_gg = __fadd_rn(s_gg, __fmul_rn(gv, gv));
    }
    out[i] = s_g;
    out[total + i] = s_p;
    out[2 * total + i] = s_gp;
    out[3 * total + i] = s_gg;
}

// Horizontal window sums of the four row-sum planes -> means -> a, b.
__global__ void box_cols_ab_kernel(const float* __restrict__ rows, float* __restrict__ ab,
                                   DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int col = static_cast<int>(i % p.W);
    const int row = static_cast<int>((i % P) / p.W);
    const long long row0 = i - col;
    const int lo = max(col - p.gf_radius, 0), hi = min(col + p.gf_radius, p.W - 1);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = lo; k <= hi; ++k)
        for (int q = 0; q < 4; ++q) s[q] = __fadd_rn(s[q], rows[q * total + row0 + k]);
    const float cnt = __fmul_rn(static_cast<float>(win_count(row, p.H, p.gf_radius)),
                                static_cast<float>(win_count(col, p.W, p.gf_radius)));
    const float mean_g = __fdiv_rn(s[0], cnt), mean_p = __fdiv_rn(s[1], cnt);
    const float corr_gp = __fdiv_rn(s[2], cnt), corr_gg = __fdiv_rn(s[3], cnt);
    const float var_g = __fsub_rn(corr_gg, __fmul_rn(mean_g, mean_g));
    const float cov_gp = __fsub_rn(corr_gp, __fmul_rn(mean_g, mean_p));
    const float a = __fdiv_rn(cov_gp, __fadd_rn(var_g, p.gf_eps));
    ab[i] = a;
    ab[total + i] = __fsub_rn(mean_p, __fmul_rn(a, mean_g));
}

// Vertical window sums of a and b into two planes.
__global__ void box_rows2_kernel(const float* __restrict__ ab, float* __restrict__ out,
                                 DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int row = static_cast<int>((i % P) / p.W);
    const long long col0 = i - static_cast<long long>(row) * p.W;
    const int lo = max(row - p.gf_radius, 0), hi = min(row + p.gf_radius, p.H - 1);
    float sa = 0.0f, sb = 0.0f;
    for (int k = lo; k <= hi; ++k) {
        const long long j = col0 + static_cast<long long>(k) * p.W;
        sa = __fadd_rn(sa, ab[j]);
        sb = __fadd_rn(sb, ab[total + j]);
    }
    out[i] = sa;
    out[total + i] = sb;
}

// Refined t of pixel i: horizontal sums of the a/b row sums -> means ->
// clip(mean_a * g + mean_b, 0, 1); t_raw without refine.
__device__ __forceinline__ float refined_t(long long i, const float* __restrict__ t_raw,
                                           const float* __restrict__ g,
                                           const float* __restrict__ ab_rows,
                                           const DehazeParams& p) {
    if (!p.refine) return t_raw[i];
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const int col = static_cast<int>(i % p.W);
    const int row = static_cast<int>((i % P) / p.W);
    const long long row0 = i - col;
    const int lo = max(col - p.gf_radius, 0), hi = min(col + p.gf_radius, p.W - 1);
    float sa = 0.0f, sb = 0.0f;
    for (int k = lo; k <= hi; ++k) {
        sa = __fadd_rn(sa, ab_rows[row0 + k]);
        sb = __fadd_rn(sb, ab_rows[total + row0 + k]);
    }
    const float cnt = __fmul_rn(static_cast<float>(win_count(row, p.H, p.gf_radius)),
                                static_cast<float>(win_count(col, p.W, p.gf_radius)));
    const float mean_a = __fdiv_rn(sa, cnt), mean_b = __fdiv_rn(sb, cnt);
    return clip01(__fadd_rn(__fmul_rn(mean_a, g[i]), mean_b));
}

// Refined t, then Eq. 8 recovery with the frame's EMA output and gamma.
__global__ void recover_kernel(const void* __restrict__ img, const float* __restrict__ t_raw,
                               const float* __restrict__ g, const float* __restrict__ ab_rows,
                               const float* __restrict__ a_seq, void* __restrict__ J,
                               void* __restrict__ t_out, DehazeParams p) {
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long total = P * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const float t = refined_t(i, t_raw, g, ab_rows, p);
    const float tt = fmaxf(t, p.t0);
    const float* A = a_seq + 3 * (i / P);
    for (int c = 0; c < 3; ++c) {
        const float x = load_px(img, 3 * i + c, p.in_dtype, p.u8_scale);
        float v = clip01(__fadd_rn(__fdiv_rn(__fsub_rn(x, A[c]), tt), A[c]));
        if (p.gamma != 1.0f) v = powf(v, p.gamma);
        store_px(J, 3 * i + c, p.out_dtype, v);
    }
    store_px(t_out, i, p.out_dtype, t);
}

// The fused transmission stage's last pass: the refined t in the output
// dtype, and nothing else.
__global__ void tmap_kernel(const float* __restrict__ t_raw, const float* __restrict__ g,
                            const float* __restrict__ ab_rows, void* __restrict__ t_out,
                            DehazeParams p) {
    const long long total = static_cast<long long>(p.H) * p.W * p.L * p.B;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    store_px(t_out, i, p.out_dtype, refined_t(i, t_raw, g, ab_rows, p));
}

// ---------------------------------------------------------------------------
// The halo form (B9): one thread per pixel of the N extended planes, or of
// the N core blocks for fd_halo_tmap.
// ---------------------------------------------------------------------------

struct ExtPixel {
    long long n;         // frame
    int y, x;            // row and column of the extended plane
};

__device__ __forceinline__ ExtPixel ext_pixel(long long i, const HaloParams& p) {
    const int we = p.w + 2 * p.halo_w;
    const long long pe = static_cast<long long>(p.h + 2 * p.halo_h) * we;
    const long long r = i % pe;
    return {i / pe, static_cast<int>(r / we), static_cast<int>(r % we)};
}

__device__ __forceinline__ long long ext_total(const HaloParams& p) {
    return static_cast<long long>(p.h + 2 * p.halo_h) * (p.w + 2 * p.halo_w) * p.N;
}

// Windowed count of valid entries of a validity vector of n entries.
__device__ __forceinline__ int valid_count(const uint8_t* __restrict__ v, int i, int n,
                                           int r) {
    int c = 0;
    for (int k = max(i - r, 0); k <= min(i + r, n - 1); ++k) c += v[k] ? 1 : 0;
    return c;
}

__device__ __forceinline__ float masked_count(const uint8_t* __restrict__ vh,
                                              const uint8_t* __restrict__ vw, int y,
                                              int x, const HaloParams& p) {
    const int he = p.h + 2 * p.halo_h, we = p.w + 2 * p.halo_w;
    return fmaxf(__fmul_rn(static_cast<float>(valid_count(vh, y, he, p.gf_radius)),
                           static_cast<float>(valid_count(vw, x, we, p.gf_radius))),
                 1.0f);
}

__global__ void halo_min_rows_kernel(const void* __restrict__ pre,
                                     const uint8_t* __restrict__ vh,
                                     const uint8_t* __restrict__ vw,
                                     float* __restrict__ y_out, HaloParams p) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= ext_total(p)) return;
    const ExtPixel q = ext_pixel(i, p);
    const int he = p.h + 2 * p.halo_h, we = p.w + 2 * p.halo_w;
    float m = INFINITY;
    if (vw[q.x]) {
        const long long col0 = i - static_cast<long long>(q.y) * we;
        for (int k = max(q.y - p.radius, 0); k <= min(q.y + p.radius, he - 1); ++k)
            if (vh[k])
                m = fminf(m, load_px(pre, col0 + static_cast<long long>(k) * we,
                                     p.pre_dtype, 1.0f));
    }
    y_out[i] = m;
}

__global__ void halo_min_cols_tmap_kernel(const float* __restrict__ x,
                                          float* __restrict__ t_ext,
                                          float* __restrict__ t_core, HaloParams p) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= ext_total(p)) return;
    const ExtPixel q = ext_pixel(i, p);
    const int we = p.w + 2 * p.halo_w;
    const long long row0 = i - q.x;
    float m = INFINITY;
    for (int k = max(q.x - p.radius, 0); k <= min(q.x + p.radius, we - 1); ++k)
        m = fminf(m, x[row0 + k]);
    const float t = p.algorithm == 0 ? __fsub_rn(1.0f, __fmul_rn(p.omega, m))
                                     : expf(__fmul_rn(p.neg_beta, m));
    t_ext[i] = t;
    const int cy = q.y - p.halo_h, cx = q.x - p.halo_w;
    if (cy >= 0 && cy < p.h && cx >= 0 && cx < p.w)
        t_core[(q.n * p.h + cy) * p.w + cx] = t;
}

// grid (N,): merge frame n's n_lists ascending lists of kk keys into its k
// smallest keys, written in ascending order: tk_t (N, k) float32, tk_idx
// (N, k) int32 (the key's index), tk_rgb (N, k, 3) in out_dt (img at that
// index). The head merge of topk_merge_kernel, writing rows instead of a sum;
// at k = 1 the lists may be single keys of any tiling (lists_ok).
__global__ void topk_list_kernel(const unsigned long long* __restrict__ keys,
                                 int n_lists, int kk, int k,
                                 const void* __restrict__ img, int img_dt,
                                 float u8_scale, long long P, float* __restrict__ tk_t,
                                 void* __restrict__ tk_rgb, int out_dt,
                                 int* __restrict__ tk_idx) {
    __shared__ unsigned long long red[kTopkThreads / 32 + 1];
    __shared__ int head[kTopkMaxLists];          // next unread key of each list
    const long long n = blockIdx.x;
    const unsigned long long* lists = keys + n * static_cast<long long>(n_lists) * kk;
    for (int j = threadIdx.x; j < n_lists; j += kTopkThreads) head[j] = 0;
    __syncthreads();
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
            const unsigned idx = static_cast<unsigned>(m & 0xffffffffULL);
            if (s + 1 < k) ++head[idx / kTopkTile];   // list j is tile j
            const long long row = n * k + s;
            tk_t[row] = key_to_t(m);
            tk_idx[row] = static_cast<int>(idx);
            const long long px = 3 * (n * P + static_cast<long long>(idx));
            for (int c = 0; c < 3; ++c)
                store_px(tk_rgb, 3 * row + c, out_dt, load_px(img, px + c, img_dt, u8_scale));
        }
        __syncthreads();                         // head[] read after the update
    }
}

// Vertical sums of the masked g, p, g*p, g*g into four planes.
__global__ void halo_box_rows4_kernel(const void* __restrict__ g,
                                      const float* __restrict__ t,
                                      const uint8_t* __restrict__ vh,
                                      const uint8_t* __restrict__ vw,
                                      float* __restrict__ out, HaloParams p) {
    const long long total = ext_total(p);
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const ExtPixel q = ext_pixel(i, p);
    const int he = p.h + 2 * p.halo_h, we = p.w + 2 * p.halo_w;
    float s_g = 0.0f, s_p = 0.0f, s_gp = 0.0f, s_gg = 0.0f;
    if (vw[q.x]) {
        const long long col0 = i - static_cast<long long>(q.y) * we;
        for (int k = max(q.y - p.gf_radius, 0); k <= min(q.y + p.gf_radius, he - 1); ++k) {
            if (!vh[k]) continue;
            const long long j = col0 + static_cast<long long>(k) * we;
            const float gv = load_px(g, j, p.guide_dtype, 1.0f), pv = t[j];
            s_g = __fadd_rn(s_g, gv);
            s_p = __fadd_rn(s_p, pv);
            s_gp = __fadd_rn(s_gp, __fmul_rn(gv, pv));
            s_gg = __fadd_rn(s_gg, __fmul_rn(gv, gv));
        }
    }
    out[i] = s_g;
    out[total + i] = s_p;
    out[2 * total + i] = s_gp;
    out[3 * total + i] = s_gg;
}

// Horizontal sums of the four row-sum planes (zero on invalid columns) ->
// masked means -> a, b.
__global__ void halo_box_cols_ab_kernel(const float* __restrict__ rows,
                                        const uint8_t* __restrict__ vh,
                                        const uint8_t* __restrict__ vw,
                                        float* __restrict__ ab, HaloParams p) {
    const long long total = ext_total(p);
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const ExtPixel q = ext_pixel(i, p);
    const int we = p.w + 2 * p.halo_w;
    const long long row0 = i - q.x;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = max(q.x - p.gf_radius, 0); k <= min(q.x + p.gf_radius, we - 1); ++k)
        if (vw[k])
            for (int c = 0; c < 4; ++c) s[c] = __fadd_rn(s[c], rows[c * total + row0 + k]);
    const float cnt = masked_count(vh, vw, q.y, q.x, p);
    const float mean_g = __fdiv_rn(s[0], cnt), mean_p = __fdiv_rn(s[1], cnt);
    const float corr_gp = __fdiv_rn(s[2], cnt), corr_gg = __fdiv_rn(s[3], cnt);
    const float var_g = __fsub_rn(corr_gg, __fmul_rn(mean_g, mean_g));
    const float cov_gp = __fsub_rn(corr_gp, __fmul_rn(mean_g, mean_p));
    const float a = __fdiv_rn(cov_gp, __fadd_rn(var_g, p.gf_eps));
    ab[i] = a;
    ab[total + i] = __fsub_rn(mean_p, __fmul_rn(a, mean_g));
}

// Vertical sums of the masked a and b into two planes.
__global__ void halo_box_rows2_kernel(const float* __restrict__ ab,
                                      const uint8_t* __restrict__ vh,
                                      const uint8_t* __restrict__ vw,
                                      float* __restrict__ out, HaloParams p) {
    const long long total = ext_total(p);
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const ExtPixel q = ext_pixel(i, p);
    const int he = p.h + 2 * p.halo_h, we = p.w + 2 * p.halo_w;
    float sa = 0.0f, sb = 0.0f;
    if (vw[q.x]) {
        const long long col0 = i - static_cast<long long>(q.y) * we;
        for (int k = max(q.y - p.gf_radius, 0); k <= min(q.y + p.gf_radius, he - 1); ++k) {
            if (!vh[k]) continue;
            const long long j = col0 + static_cast<long long>(k) * we;
            sa = __fadd_rn(sa, ab[j]);
            sb = __fadd_rn(sb, ab[total + j]);
        }
    }
    out[i] = sa;
    out[total + i] = sb;
}

// One thread per core pixel of the N frames: horizontal sums of the a/b
// row sums -> masked means -> clip(mean_a * g + mean_b, 0, 1), or t_raw
// without refine; in the output dtype.
__global__ void halo_tmap_kernel(const float* __restrict__ t_core,
                                 const void* __restrict__ g,
                                 const float* __restrict__ ab_rows,
                                 const uint8_t* __restrict__ vh,
                                 const uint8_t* __restrict__ vw,
                                 void* __restrict__ t_out, HaloParams p) {
    const long long P = static_cast<long long>(p.h) * p.w;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= P * p.N) return;
    if (!p.refine) {
        store_px(t_out, i, p.out_dtype, t_core[i]);
        return;
    }
    const long long total = ext_total(p);
    const int we = p.w + 2 * p.halo_w;
    const long long n = i / P;
    const int y = static_cast<int>((i % P) / p.w) + p.halo_h;
    const int x = static_cast<int>(i % p.w) + p.halo_w;
    const long long e = (n * (p.h + 2 * p.halo_h) + y) * we + x;
    const long long row0 = e - x;
    float sa = 0.0f, sb = 0.0f;
    for (int k = max(x - p.gf_radius, 0); k <= min(x + p.gf_radius, we - 1); ++k) {
        if (!vw[k]) continue;
        sa = __fadd_rn(sa, ab_rows[row0 + k]);
        sb = __fadd_rn(sb, ab_rows[total + row0 + k]);
    }
    const float cnt = masked_count(vh, vw, y, x, p);
    const float mean_a = __fdiv_rn(sa, cnt), mean_b = __fdiv_rn(sb, cnt);
    const float gv = load_px(g, e, p.guide_dtype, 1.0f);
    store_px(t_out, i, p.out_dtype, clip01(__fadd_rn(__fmul_rn(mean_a, gv), mean_b)));
}

// ---------------------------------------------------------------------------
// The tiled passes: one block a kTileH x kTileW output tile of one plane (a
// frame for B1 and B7, an extended plane for B9), its inputs with their
// window halo in shared memory. Each pass is one kernel template over the
// ends of its call, an Io type: where its inputs come from, where its
// outputs go, and whether pixels are masked. The window arithmetic between
// them is the same code for B1, B7 and B9.
// ---------------------------------------------------------------------------

// The tile and the guided pass's minimum blocks an SM are the tuning knobs
// of kernels/tuning.py (ops fused_*, fused_halo_2d): each set of values is
// a library of its own, built with -D FD_TILE_H=.. -D FD_TILE_W=.. -D
// FD_GUIDED_MIN_BLOCKS=.. (kernels/_build.py); these defaults are the
// library built without them. 32 x 64 and 64 x 32 both keep 256 threads.
#ifndef FD_TILE_H
#define FD_TILE_H 32
#endif
#ifndef FD_TILE_W
#define FD_TILE_W 64
#endif
#ifndef FD_GUIDED_MIN_BLOCKS
#define FD_GUIDED_MIN_BLOCKS 3
#endif
constexpr int kTileH = FD_TILE_H;                // output rows of a tile
constexpr int kTileW = FD_TILE_W;                // output columns of a tile
constexpr int kGuidedMinBlocks = FD_GUIDED_MIN_BLOCKS;   // guided_ab's __launch_bounds__
constexpr int kTileThreads = 256;
constexpr int kRunV = 16;                        // vertical window outputs a thread
constexpr int kRunVMin = 8;                      // the same for tmap_tile's narrower window
constexpr int kRunH = 8;                         // horizontal window outputs a thread
static_assert(kTileH % kRunV == 0 && kTileH % kRunVMin == 0 && kTileW % kRunH == 0,
              "whole runs a tile");
static_assert(kTileH * (kTileW / kRunH) == kTileThreads, "one horizontal run a thread");
static_assert(kTileH % 32 == 0, "a warp's lanes are 32 rows of a tile in the horizontal runs");
static_assert(kGuidedMinBlocks >= 1, "at least one block an SM");

// Shared memory of the tiled passes. A tile's inputs span (kTileH + 2r) x
// (kTileW + 2r) of its plane; regions are reused once spent.
__host__ __device__ __forceinline__ int halo_rows(int r) { return kTileH + 2 * r; }
__host__ __device__ __forceinline__ int halo_cols(int r) { return kTileW + 2 * r; }
__host__ __device__ __forceinline__ int run_stride(int r) { return halo_cols(r) | 1; }
constexpr int kStageStride = kTileW + 1;         // a staged output row

__host__ __device__ __forceinline__ int max_i(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }

// Bytes of a frame row's wire pixels staged from a 16-byte boundary:
// n pixels of 3 elements of es bytes, plus the alignment slack.
__host__ __device__ __forceinline__ int wire_row_bytes(int n, int es) {
    return ((3 * n * es + 15) / 16 + 1) * 16;
}

__host__ __device__ __forceinline__ int elem_bytes(int dt) {
    return dt == 0 ? 4 : (dt == 1 ? 2 : 1);
}

// np halo planes, or np staged output tiles once the planes are spent.
__host__ __device__ __forceinline__ int in_floats(int np, int r) {
    return max_i(np * halo_rows(r) * halo_cols(r), np * kTileH * kStageStride);
}

// tmap_tile: the wire rows (then the vertical minima), the pre-map (then
// the staged t_raw), a byte offset a halo row.
__host__ __device__ __forceinline__ int tmap_wire_bytes(const DehazeParams& p) {
    const int r = p.radius;
    return max_i(halo_rows(r) * wire_row_bytes(halo_cols(r), elem_bytes(p.in_dtype)),
                 4 * kTileH * run_stride(r));
}

inline size_t tmap_smem(const DehazeParams& p) {
    return tmap_wire_bytes(p) + sizeof(float) * in_floats(1, p.radius) +
           sizeof(int) * halo_rows(p.radius);
}

// Whether every vertical run of a tile with an r-halo has a thread: then
// the runs' sums may overwrite the halo planes they are taken from.
__host__ __device__ __forceinline__ bool runs_overlay(int r) {
    return halo_cols(r) * (kTileH / kRunV) <= kTileThreads;
}

// np halo planes (or staged output tiles) and the vertical runs' sums of
// nv planes: one region where the sums overwrite the planes, else two.
__host__ __device__ __forceinline__ int planes_and_runs(int np, int nv, int r) {
    const int runs = nv * kTileH * run_stride(r);
    return runs_overlay(r) ? max_i(in_floats(np, r), runs) : in_floats(np, r) + runs;
}

inline size_t guided_smem(const DehazeParams& p) {
    return sizeof(float) * planes_and_runs(2, 4, p.gf_radius);
}

// refine_recover: the tile's wire rows, the guide or t_raw tile, and with
// refine the a/b halo planes (then mean_a, mean_b, t) and the window runs.
// refine_tmap (B7) is the same without the wire rows.
__host__ __device__ __forceinline__ int recover_wire_bytes(const DehazeParams& p) {
    return kTileH * wire_row_bytes(kTileW, elem_bytes(p.in_dtype));
}

__host__ __device__ __forceinline__ int refine_floats(int refine, int r) {
    return kTileH * kTileW + (refine ? planes_and_runs(2, 2, r) : kTileH * kStageStride);
}

inline size_t recover_smem(const DehazeParams& p) {
    return recover_wire_bytes(p) + sizeof(float) * refine_floats(p.refine, p.gf_radius);
}

inline size_t refine_tmap_smem(const DehazeParams& p) {
    return sizeof(float) * refine_floats(p.refine, p.gf_radius);
}

// The halo form's tiled passes (B9) stage no wire rows, and hold the prefix
// counts of a tile's valid halo rows and columns.
__host__ __device__ __forceinline__ int count_ints(int r) {
    return halo_rows(r) + 1 + halo_cols(r) + 1;
}

inline size_t halo_tmap_smem(const HaloParams& p) {
    return sizeof(float) * (kTileH * run_stride(p.radius) + in_floats(1, p.radius)) +
           sizeof(int) * count_ints(p.radius);
}

inline size_t halo_guided_smem(const HaloParams& p) {
    return sizeof(float) * planes_and_runs(2, 4, p.gf_radius) +
           sizeof(int) * count_ints(p.gf_radius);
}

inline size_t halo_refine_smem(const HaloParams& p) {
    return sizeof(float) * refine_floats(p.refine, p.gf_radius) +
           (p.refine ? sizeof(int) * count_ints(p.gf_radius) : 0);
}

// The vertical window runs of a tile with an r-halo: run(it, s) computes
// run it's kRunV sums of NP planes, store(it, s) writes them. Where the
// sums overwrite their inputs (runs_overlay), every run is computed before
// any is stored; the caller synchronises before reading them.
template <int NP, class Run, class Store>
__device__ __forceinline__ void vertical_runs(int r, const Run& run, const Store& store) {
    const int items = halo_cols(r) * (kTileH / kRunV);
    if (runs_overlay(r)) {
        float s[NP][kRunV];
        const bool active = threadIdx.x < items;
        if (active) run(threadIdx.x, s);
        __syncthreads();
        if (active) store(threadIdx.x, s);
    } else {
        for (int it = threadIdx.x; it < items; it += kTileThreads) {
            float s[NP][kRunV];
            run(it, s);
            store(it, s);
        }
    }
}

// The rows [y0, y1) and columns [x0, x1) of a plane whose outputs a pass
// writes, and the column ox <= x0 where its first tiles start.
struct Region {
    int y0, y1, x0, x1, ox;
};

// A tile: plane n of P = H x W pixels (the windows stop at its edge), its
// first output (y0, x0), the pass's output region's columns [x_lo, x1) and
// rows up to y1, and the plane position (yi, xi) of halo element (0, 0).
struct Tile {
    long long n, P;
    int H, W, y1, x_lo, x1;
    int y0, x0, yi, xi;

    __device__ __forceinline__ bool writes(int y, int x) const {
        return y < y1 && x >= x_lo && x < x1;
    }
};

// Tile (blockIdx.x, blockIdx.y) of region rg of plane blockIdx.z, r-halo.
__device__ __forceinline__ Tile region_tile(int H, int W, const Region& rg, int r) {
    const int y0 = rg.y0 + blockIdx.y * kTileH, x0 = rg.ox + blockIdx.x * kTileW;
    return {static_cast<long long>(blockIdx.z), static_cast<long long>(H) * W, H, W,
            rg.y1, rg.x0, rg.x1, y0, x0, y0 - r, x0 - r};
}

// B1 and B7: the outputs are the whole frame. The grid's planes run in
// the order p.lane_major names (the fused_lanes tuning knob grid_order):
// plane z is frame z (lane z / B) lane-major, frame (z % L) x B + z / L
// frame-major, so the lanes interleave block by block.
__device__ __forceinline__ Tile this_tile(const DehazeParams& p, int r) {
    Tile t = region_tile(p.H, p.W, {0, p.H, 0, p.W, 0}, r);
    if (!p.lane_major) {
        const int z = static_cast<int>(blockIdx.z);
        t.n = static_cast<long long>(z % p.L) * p.B + z / p.L;
    }
    return t;
}

// B9: the extended plane, and the part of it that a pass writes: the core
// widened by m a side. tmap_tile writes t_raw on core +- 2 gf_r (the core
// alone without refine), guided_ab a and b on core +- gf_r, refine_tmap t
// on the core. Each output of a pass reads only pixels that the pass before
// wrote, so the results are those of passes over the whole plane.
__host__ __device__ __forceinline__ int ext_h(const HaloParams& p) { return p.h + 2 * p.halo_h; }
__host__ __device__ __forceinline__ int ext_w(const HaloParams& p) { return p.w + 2 * p.halo_w; }

__host__ __device__ __forceinline__ Region halo_region(const HaloParams& p, int m) {
    const int x0 = max_i(p.halo_w - m, 0);
    return {max_i(p.halo_h - m, 0), min_i(p.halo_h + p.h + m, ext_h(p)), x0,
            min_i(p.halo_w + p.w + m, ext_w(p)), x0};
}

// The sums' passes (guided_ab, refine_tmap) start their tiles a column
// early where that puts their r-halo on an even column: then a float32
// plane of even width copies 8 bytes a cp.async, not 4 (copy_window).
__host__ __device__ __forceinline__ Region sums_region(const HaloParams& p, int m) {
    Region rg = halo_region(p, m);
    rg.ox -= (rg.x0 - p.gf_radius) & 1;
    return rg;
}

__host__ __device__ __forceinline__ int tmap_margin(const HaloParams& p) {
    return p.refine ? 2 * p.gf_radius : 0;
}

__device__ __forceinline__ Tile halo_tile(const Region& rg, const HaloParams& p, int r) {
    return region_tile(ext_h(p), ext_w(p), rg, r);
}

// copy_window's copies of kV floats each (4, 2 or 1).
template <int kV>
__device__ __forceinline__ void copy_window_by(const float* __restrict__ base,
                                               long long plane_stride, int np, float* dst,
                                               const Tile& t, int y_first, int x_first,
                                               int rows, int cols) {
    const int lane = threadIdx.x & 31;
    for (int q = 0; q < np; ++q)
        for (int i = threadIdx.x >> 5; i < rows; i += kTileThreads / 32) {
            const int y = y_first + i;
            const bool row_in = y >= 0 && y < t.H;
            const float* src = base + q * plane_stride + t.n * t.P +
                               static_cast<long long>(row_in ? y : 0) * t.W;
            float* d = dst + (q * rows + i) * cols;
            for (int j = lane * kV; j < cols; j += 32 * kV) {
                const int x = x_first + j;
                const bool in = row_in && x >= 0 && x < t.W;
                const float* from = in ? src + x : base;
                if constexpr (kV == 4) cp_async16(d + j, from, in ? 16 : 0);
                else if constexpr (kV == 2) cp_async8(d + j, from, in ? 8 : 0);
                else cp_async4(d + j, from, in ? 4 : 0);
            }
        }
}

// Starts the copies of a rows x cols window of np float32 planes (plane q
// at base + q * plane_stride; window element (0, 0) at plane row y_first,
// column x_first) into dst[q] (rows x cols floats, 16-byte aligned), zero
// off the plane. A warp a row, its lanes along it: 16 bytes a copy where
// the window's columns, the plane width and the planes fall on 4-float
// boundaries (each 4 floats then lie wholly on or off the plane), 8 where
// they fall on 2-float boundaries, else 4.
__device__ __forceinline__ void copy_window(const float* __restrict__ base,
                                            long long plane_stride, int np, float* dst,
                                            const Tile& t, int y_first, int x_first, int rows,
                                            int cols) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(base);
    const int bounds = x_first | cols | t.W | static_cast<int>(plane_stride & 3);
    if ((bounds & 3) == 0 && (at & 15) == 0)
        copy_window_by<4>(base, plane_stride, np, dst, t, y_first, x_first, rows, cols);
    else if ((bounds & 1) == 0 && (at & 7) == 0)
        copy_window_by<2>(base, plane_stride, np, dst, t, y_first, x_first, rows, cols);
    else
        copy_window_by<1>(base, plane_stride, np, dst, t, y_first, x_first, rows, cols);
}

// Stages a rows x cols window of plane t.n of the (N, H, W) planes at base,
// of dtype kDt (0 float32, 1 bfloat16), into dst as float32, zero off the
// plane: float32 by cp.async (copy_window), bfloat16 by loads converted on
// the way (a cp.async moves at least 4 bytes).
template <int kDt>
__device__ __forceinline__ void stage_plane(const void* __restrict__ base, float* dst,
                                            const Tile& t, int y_first, int x_first, int rows,
                                            int cols) {
    if constexpr (kDt == 0) {
        copy_window(static_cast<const float*>(base), 0, 1, dst, t, y_first, x_first, rows, cols);
    } else {
        const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(base) + t.n * t.P;
        const int lane = threadIdx.x & 31;
        for (int i = threadIdx.x >> 5; i < rows; i += kTileThreads / 32) {
            const int y = y_first + i;
            const bool row_in = y >= 0 && y < t.H;
            for (int j = lane; j < cols; j += 32) {
                const int x = x_first + j;
                dst[i * cols + j] = row_in && x >= 0 && x < t.W
                    ? __bfloat162float(b[static_cast<long long>(y) * t.W + x]) : 0.0f;
            }
        }
    }
}

// B9's mask counts, once a tile: pr[i] = the valid rows among the tile's
// halo rows 0 .. i-1 (halo_rows(r) + 1 entries), pc[j] likewise over its
// halo columns, a pixel off the plane invalid; warp 0 counts the rows,
// warp 1 the columns, 32 at a time by ballot. They read only the validity
// bytes, so they run while the tile's copies are in flight; the caller
// synchronises before reading them.
__device__ __forceinline__ void mask_counts(int* pr, int* pc, const Tile& t, int r,
                                            const uint8_t* __restrict__ vh,
                                            const uint8_t* __restrict__ vw) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp > 1) return;
    const bool by_row = warp == 0;
    const uint8_t* v = by_row ? vh : vw;
    const int first = by_row ? t.yi : t.xi, n = by_row ? halo_rows(r) : halo_cols(r);
    const int lim = by_row ? t.H : t.W;
    int* out = by_row ? pr : pc;
    int carry = 0;
    for (int b = 0; b < n; b += 32) {
        const int i = b + lane, k = first + i;
        const bool ok = i < n && k >= 0 && k < lim && v[k] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (i < n) out[i] = carry + __popc(m & ((1u << lane) - 1u));
        carry += __popc(m);
    }
    if (lane == 0) out[n] = carry;
}

// Whether the mask counts say every pixel of a tile's halo is valid: then
// the staged windows need no mask (most tiles of a shard's planes).
__device__ __forceinline__ bool all_valid(const int* pr, const int* pc, int r) {
    return pr[halo_rows(r)] == halo_rows(r) && pc[halo_cols(r)] == halo_cols(r);
}

// B9's mask at load: every element of np staged windows of a tile's r-halo
// (as copy_window lays them out) whose row or column the mask counts find
// invalid becomes fill (+inf for a min, +0 for a sum). A select, not a
// product: t_raw is -inf on invalid rows deeper than r past a frame's edge,
// and 0 * -inf is NaN. A sum from +0 that adds +0 keeps its bits, so the
// sums equal the ten masked passes', which skip those terms. After the
// copies have landed and the counts are read; the caller synchronises.
__device__ __forceinline__ void mask_window(float* dst, int np, int r, const int* pr,
                                            const int* pc, float fill) {
    const int rows = halo_rows(r), cols = halo_cols(r), lane = threadIdx.x & 31;
    for (int q = 0; q < np; ++q)
        for (int i = threadIdx.x >> 5; i < rows; i += kTileThreads / 32) {
            const bool row_ok = pr[i + 1] != pr[i];
            float* d = dst + (q * rows + i) * cols;
            for (int j = lane; j < cols; j += 32)
                if (!(row_ok && pc[j + 1] != pc[j])) d[j] = fill;
        }
}

// The divisor of tile output (row, col) from the mask counts: masked_count's
// own operations on its window's valid rows and columns.
__device__ __forceinline__ float mask_count(const int* pr, const int* pc, int row, int col,
                                            int r) {
    return fmaxf(__fmul_rn(static_cast<float>(pr[row + 2 * r + 1] - pr[row]),
                           static_cast<float>(pc[col + 2 * r + 1] - pc[col])),
                 1.0f);
}

// Starts the copies of frame rows y_first .. y_first + rows - 1, columns
// [x_first, x_first + cols) clipped to the frame, of the (L*B, H, W, 3)
// wire frames: each row's bytes from the 16-byte boundary at or below its
// first in-frame pixel into dst + i * row_bytes; off[i] = that pixel's
// byte within the staged row. Rows off the frame are left alone. Plain
// byte loads where the frames do not start on a 16-byte boundary.
__device__ __forceinline__ void copy_wire_rows(const void* __restrict__ img, uint8_t* dst,
                                               int* off, const Tile& t, int y_first,
                                               int x_first, int rows, int cols,
                                               int row_bytes, const DehazeParams& p) {
    const int es = elem_bytes(p.in_dtype);
    const uint8_t* bytes = static_cast<const uint8_t*>(img);
    const long long total = 3LL * es * t.P * p.L * p.B;
    const bool aligned = (reinterpret_cast<uintptr_t>(img) & 15) == 0;
    const int xs = max(x_first, 0), xe = min(x_first + cols, p.W);
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < rows; i += kTileThreads / 32) {
        const int y = y_first + i;
        if (y < 0 || y >= p.H) continue;
        const long long px = t.n * t.P + static_cast<long long>(y) * p.W;
        const long long s0 = 3LL * es * (px + xs), s1 = 3LL * es * (px + xe);
        uint8_t* d = dst + i * row_bytes;
        if (aligned) {
            const long long a0 = s0 & ~15LL;
            if (lane == 0) off[i] = static_cast<int>(s0 - a0);
            const int words = static_cast<int>((s1 - a0 + 15) >> 4);
            for (int w = lane; w < words; w += 32) {
                const long long b = a0 + 16LL * w;
                cp_async16(d + 16 * w, bytes + b, static_cast<int>(min(16LL, total - b)));
            }
        } else {
            if (lane == 0) off[i] = 0;
            for (long long b = s0 + lane; b < s1; b += 32) d[b - s0] = bytes[b];
        }
    }
}

// Element c of the pixel whose channel 0 is at b (a staged wire row of
// dtype kIn), as load_px reads it.
template <int kIn>
__device__ __forceinline__ float staged_px(const uint8_t* b, int c, float u8_scale) {
    if constexpr (kIn == 0) return reinterpret_cast<const float*>(b)[c];
    else if constexpr (kIn == 1)
        return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(b)[c]);
    else return __fmul_rn(static_cast<float>(b[c]), u8_scale);
}

// store_px for an output dtype known at compile time.
template <int kOut>
__device__ __forceinline__ void store_out(void* p, long long i, float v) {
    if constexpr (kOut == 0) static_cast<float*>(p)[i] = v;
    else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// Pass 1, tmap_tile: the pre-map with an r-halo -> vertical then horizontal
// windowed min -> t_raw, and at top-1 each tile's smallest (t, index) key.
// ---------------------------------------------------------------------------

// B1, B7: the (L*B, H, W, 3) wire frames of dtype kIn, staged as bytes and
// pre-mapped with the lane's saved A (+inf off the frame), the luma g
// written on the way (refine); t_raw over the frame, keys under the
// frame's flat index.
template <int kIn>
struct FrameTmap {
    const void* img;
    const float* carry_f;
    float* t_raw;
    float* g;
    unsigned long long* keys;
    DehazeParams p;

    __host__ __device__ __forceinline__ static int stage_bytes(const DehazeParams& q) {
        return tmap_wire_bytes(q);
    }
    __device__ __forceinline__ Tile tile(int r) const { return this_tile(p, r); }

    __device__ __forceinline__ void stage(uint8_t* wire, float* pre, int* off,
                                          const Tile& t) const {
        const int r = p.radius, rows = halo_rows(r), cols = halo_cols(r);
        const int es = elem_bytes(kIn), row_bytes = wire_row_bytes(cols, es);
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        copy_wire_rows(img, wire, off, t, t.yi, t.xi, rows, cols, row_bytes, p);
        cp_async_wait();
        __syncthreads();
        const Divisors a = lane_divisors(carry_f, static_cast<int>(t.n / p.B), p);
        const int xs = max(t.xi, 0);
        for (int i = warp; i < rows; i += kTileThreads / 32) {
            const int y = t.yi + i;
            const bool row_in = y >= 0 && y < p.H;
            const uint8_t* w = wire + i * row_bytes + (row_in ? off[i] : 0);
            for (int j = lane; j < cols; j += 32) {
                const int x = t.xi + j;
                float v = INFINITY;
                if (row_in && x >= 0 && x < p.W) {
                    const uint8_t* px = w + 3 * es * (x - xs);
                    const float cr = staged_px<kIn>(px, 0, p.u8_scale);
                    const float cg = staged_px<kIn>(px, 1, p.u8_scale);
                    const float cb = staged_px<kIn>(px, 2, p.u8_scale);
                    v = premap_px(cr, cg, cb, a, p);
                    if (g != nullptr && i >= r && i < r + kTileH && j >= r && j < r + kTileW)
                        g[t.n * t.P + static_cast<long long>(y) * p.W + x] = luma_px(cr, cg, cb, p);
                }
                pre[i * cols + j] = v;
            }
        }
    }

    __device__ __forceinline__ bool keyed(int y, int x) const { return y < p.H && x < p.W; }
    __device__ __forceinline__ unsigned key_index(int y, int x) const {
        return static_cast<unsigned>(static_cast<long long>(y) * p.W + x);
    }
    __device__ __forceinline__ void store(const Tile& t, int y, int x, float v) const {
        t_raw[t.n * t.P + static_cast<long long>(y) * p.W + x] = v;
    }
};

// B9: the extended pre-map plane of dtype kPre, +inf where a pixel is
// invalid; t_raw on its region of the extended plane and on the (N, h, w)
// core, keys of the core's pixels under their core index.
template <int kPre>
struct HaloTmap {
    const void* pre;
    const uint8_t* vh;
    const uint8_t* vw;
    float* t_ext;
    float* t_core;
    unsigned long long* keys;
    HaloParams p;

    __host__ __device__ __forceinline__ static int stage_bytes(const HaloParams& q) {
        return static_cast<int>(sizeof(float)) * kTileH * run_stride(q.radius);
    }
    __device__ __forceinline__ Tile tile(int r) const {
        return halo_tile(halo_region(p, tmap_margin(p)), p, r);
    }

    // counts: the mask counts (pr, then pc), where B1 keeps its row offsets.
    __device__ __forceinline__ void stage(uint8_t*, float* dst, int* counts, const Tile& t) const {
        const int r = p.radius;
        int* pc = counts + halo_rows(r) + 1;
        stage_plane<kPre>(pre, dst, t, t.yi, t.xi, halo_rows(r), halo_cols(r));
        mask_counts(counts, pc, t, r, vh, vw);
        cp_async_wait();
        __syncthreads();
        if (!all_valid(counts, pc, r)) mask_window(dst, 1, r, counts, pc, INFINITY);
    }

    __device__ __forceinline__ bool keyed(int y, int x) const {
        return y >= p.halo_h && y < p.halo_h + p.h && x >= p.halo_w && x < p.halo_w + p.w;
    }
    __device__ __forceinline__ unsigned key_index(int y, int x) const {
        return static_cast<unsigned>(static_cast<long long>(y - p.halo_h) * p.w + x - p.halo_w);
    }
    __device__ __forceinline__ void store(const Tile& t, int y, int x, float v) const {
        t_ext[t.n * t.P + static_cast<long long>(y) * t.W + x] = v;
        if (keyed(y, x))
            t_core[(t.n * p.h + y - p.halo_h) * p.w + x - p.halo_w] = v;
    }
};

// grid (tiles_x, tiles_y, planes) over the pass's region, block
// kTileThreads, Io's shared memory (tmap_smem, halo_tmap_smem): the
// staged pre-map -> vertical then horizontal windowed min -> t_raw,
// written over the region; where keys is given, the tile's smallest
// (t, index) key at keys[(n * tiles_y + tile_y) * tiles_x + tile_x]
// (kNoKey for a tile without a keyed pixel).
template <class Io>
__global__ void __launch_bounds__(kTileThreads) tmap_tile_kernel(const Io io) {
    extern __shared__ __align__(16) uint8_t smem_bytes[];
    __shared__ unsigned long long red[kTileThreads / 32 + 1];
    const int r = io.p.radius;
    const Tile t = io.tile(r);
    const int cols = halo_cols(r), vstride = run_stride(r);
    float* vmin = reinterpret_cast<float*>(smem_bytes);   // [kTileH][vstride], once staged
    float* pre = reinterpret_cast<float*>(smem_bytes + Io::stage_bytes(io.p));   // [rows][cols]
    float* tst = pre;                            // [kTileH][kStageStride], after pre
    int* off = reinterpret_cast<int*>(pre + in_floats(1, r));   // B1's [rows], B9's counts
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    io.stage(smem_bytes, pre, off, t);
    __syncthreads();
    for (int it = threadIdx.x; it < cols * (kTileH / kRunVMin); it += kTileThreads) {
        const int c = it % cols, row0 = (it / cols) * kRunVMin;
        float m[1][kRunVMin];
        window_run<1, kRunVMin, false>(
            [&](int k, float (&v)[1]) { v[0] = pre[(row0 + k) * cols + c]; }, 2 * r, m);
#pragma unroll
        for (int j = 0; j < kRunVMin; ++j) vmin[(row0 + j) * vstride + c] = m[0][j];
    }
    __syncthreads();
    const int row = threadIdx.x % kTileH, col0 = (threadIdx.x / kTileH) * kRunH;
    float m[1][kRunH];
    window_run<1, kRunH, false>(
        [&](int k, float (&v)[1]) { v[0] = vmin[row * vstride + col0 + k]; }, 2 * r, m);
    const int y = t.y0 + row;
    unsigned long long best = kNoKey;
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
        const int x = t.x0 + col0 + j;
        const float tv = tmap_of(m[0][j], io.p);
        tst[row * kStageStride + col0 + j] = tv;
        if (io.keyed(y, x)) {
            const unsigned long long key = make_key(tv, io.key_index(y, x));
            best = key < best ? key : best;
        }
    }
    if (io.keys != nullptr) {
        best = block_min_u64<kTileThreads>(best, red);
        if (threadIdx.x == 0)
            io.keys[(t.n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = best;
    }
    __syncthreads();
    for (int i = warp; i < kTileH; i += kTileThreads / 32) {
        const int yy = t.y0 + i;
        for (int j = lane; j < kTileW; j += 32) {
            const int x = t.x0 + j;
            if (t.writes(yy, x)) io.store(t, yy, x, tst[i * kStageStride + j]);
        }
    }
}

// Pass 2, select_ema (topk_merge and ema). grid (L,), block kTopkThreads,
// 3 * B floats of shared memory: the candidates of lane l's B frames, then
// B steps of Eq. 9 in order. At k = 1 the keys are the tiles' single keys
// (n_lists a frame, kk = 1) and a warp takes a frame's smallest, one frame
// a warp at a time; at k > 1 they are topk_block's ascending lists and the
// block merges one frame after another.
__global__ void select_ema_kernel(const unsigned long long* __restrict__ keys, int n_lists,
                                  int kk, const void* __restrict__ img,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ carry_f,
                                  const int* __restrict__ carry_i, float* __restrict__ a_seq,
                                  float* __restrict__ carry_f_out,
                                  int* __restrict__ carry_i_out, DehazeParams p) {
    extern __shared__ float cand[];              // [B][3]
    __shared__ unsigned long long red[kTopkThreads / 32 + 1];
    __shared__ int head[kTopkMaxLists];
    const int lane = blockIdx.x;
    const long long P = static_cast<long long>(p.H) * p.W;
    const long long stride = static_cast<long long>(n_lists) * kk;
    if (p.topk == 1) {
        for (int b = threadIdx.x / 32; b < p.B; b += kTopkThreads / 32) {
            const long long n = static_cast<long long>(lane) * p.B + b;
            const unsigned long long m = warp_min_keys(keys + n * stride, n_lists);
            if ((threadIdx.x & 31) == 0) {
                RgbSum sum;
                sum.add(img, 3 * (n * P + static_cast<long long>(m & 0xffffffffULL)),
                        p.in_dtype, p.u8_scale);
                for (int q = 0; q < 3; ++q) cand[3 * b + q] = sum.mean(q, 1);
            }
        }
    } else {
        for (int b = 0; b < p.B; ++b) {
            const long long n = static_cast<long long>(lane) * p.B + b;
            RgbSum sum;
            unsigned long long first;
            merge_heads<kTopkThreads>(keys + n * stride, n_lists, kk, p.topk, img, p.in_dtype,
                                      p.u8_scale, n * P, head, red, sum, first);
            if (threadIdx.x == 0)
                for (int q = 0; q < 3; ++q) cand[3 * b + q] = sum.mean(q, p.topk);
        }
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float A[3] = {carry_f[3 * lane], carry_f[3 * lane + 1], carry_f[3 * lane + 2]};
    int k = carry_i[2 * lane];
    int inited = carry_i[2 * lane + 1];
    for (int b = 0; b < p.B; ++b) {
        const long long n = static_cast<long long>(lane) * p.B + b;
        ema_step(A, k, inited, cand + 3 * b, ids[n], a_seq + 3 * n, p.period, p.lam,
                 p.one_minus_lam);
    }
    for (int c = 0; c < 3; ++c) carry_f_out[3 * lane + c] = A[c];
    carry_i_out[2 * lane] = k;
    carry_i_out[2 * lane + 1] = inited;
}

// ---------------------------------------------------------------------------
// Pass 3, guided_ab: the guide g and t_raw with a gf_r-halo -> vertical sums
// of g, p, g*p, g*g (the products formed as each input is fetched) ->
// horizontal sums -> means -> the guided filter's a and b.
// ---------------------------------------------------------------------------

// B1, B7: the float32 g and t_raw planes of the frames, zero off the frame,
// the means over the closed-form count; a and b over the frame.
struct FrameGuided {
    const float* g;
    const float* t_raw;
    float* ab;
    DehazeParams p;
    static constexpr bool kMasked = false;

    __device__ __forceinline__ Tile tile(int r) const { return this_tile(p, r); }
    __device__ __forceinline__ long long planes() const {
        return static_cast<long long>(p.H) * p.W * p.L * p.B;
    }
    __device__ __forceinline__ void stage(float* in, const Tile& t, int rows, int cols) const {
        copy_window(g, 0, 1, in, t, t.yi, t.xi, rows, cols);
        copy_window(t_raw, 0, 1, in + rows * cols, t, t.yi, t.xi, rows, cols);
    }
};

// B9: the extended guide plane (dtype kG) and t_raw, masked to +0, the
// means over masked_count's divisor; a and b on core +- gf_r.
template <int kG>
struct HaloGuided {
    const void* g;
    const float* t_ext;
    const uint8_t* vh;
    const uint8_t* vw;
    float* ab;
    HaloParams p;
    static constexpr bool kMasked = true;

    __device__ __forceinline__ Tile tile(int r) const {
        return halo_tile(sums_region(p, p.gf_radius), p, r);
    }
    __device__ __forceinline__ long long planes() const {
        return static_cast<long long>(ext_h(p)) * ext_w(p) * p.N;
    }
    __device__ __forceinline__ void stage(float* in, const Tile& t, int rows, int cols) const {
        stage_plane<kG>(g, in, t, t.yi, t.xi, rows, cols);
        copy_window(t_ext, 0, 1, in + rows * cols, t, t.yi, t.xi, rows, cols);
    }
};

// grid as tmap_tile over the pass's region, Io's shared memory
// (guided_smem, halo_guided_smem); a and b written to ab (2, planes).
template <class Io>
__global__ void __launch_bounds__(kTileThreads, kGuidedMinBlocks) guided_ab_kernel(const Io io) {
    extern __shared__ __align__(16) float smem[];
    const int r = io.p.gf_radius;
    const Tile t = io.tile(r);
    const int rows = halo_rows(r), cols = halo_cols(r), vstride = run_stride(r);
    const long long total = io.planes();
    float* in = smem;                            // g, p: [2][rows][cols]
    float4* vs = reinterpret_cast<float4*>(runs_overlay(r) ? smem : smem + in_floats(2, r));
    float* ost = smem;                           // a, b: [2][kTileH][kStageStride], at the end
    int* pr = reinterpret_cast<int*>(smem + planes_and_runs(2, 4, r));   // masked: mask counts
    int* pc = pr + rows + 1;
    io.stage(in, t, rows, cols);
    if constexpr (Io::kMasked) mask_counts(pr, pc, t, r, io.vh, io.vw);
    cp_async_wait();
    __syncthreads();
    if constexpr (Io::kMasked) {
        if (!all_valid(pr, pc, r)) {
            mask_window(in, 2, r, pr, pc, 0.0f);
            __syncthreads();
        }
    }
    const float* in_g = in;
    const float* in_p = in + rows * cols;
    vertical_runs<4>(
        r,
        [&](int it, float (&s)[4][kRunV]) {
            const int c = it % cols, row0 = (it / cols) * kRunV;
            window_run<4, kRunV, true>(
                [&](int k, float (&v)[4]) {
                    const int e = (row0 + k) * cols + c;
                    const float gv = in_g[e], pv = in_p[e];
                    v[0] = gv;
                    v[1] = pv;
                    v[2] = __fmul_rn(gv, pv);
                    v[3] = __fmul_rn(gv, gv);
                },
                2 * r, s);
        },
        [&](int it, const float (&s)[4][kRunV]) {
            const int c = it % cols, row0 = (it / cols) * kRunV;
#pragma unroll
            for (int j = 0; j < kRunV; ++j)
                vs[(row0 + j) * vstride + c] = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        });
    __syncthreads();
    const int row = threadIdx.x % kTileH, col0 = (threadIdx.x / kTileH) * kRunH;
    const float4* vrow = vs + row * vstride + col0;
    float s[4][kRunH];
    window_run<4, kRunH, true>(
        [&](int k, float (&v)[4]) {
            const float4 f = vrow[k];
            v[0] = f.x;
            v[1] = f.y;
            v[2] = f.z;
            v[3] = f.w;
        },
        2 * r, s);
    const float cnt_y = static_cast<float>(win_count(t.y0 + row, t.H, r));
    float out_a[kRunH], out_b[kRunH];
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
        float cnt;
        if constexpr (Io::kMasked)
            cnt = mask_count(pr, pc, row, col0 + j, r);
        else
            cnt = __fmul_rn(cnt_y, static_cast<float>(win_count(t.x0 + col0 + j, t.W, r)));
        const float mean_g = __fdiv_rn(s[0][j], cnt), mean_p = __fdiv_rn(s[1][j], cnt);
        const float corr_gp = __fdiv_rn(s[2][j], cnt), corr_gg = __fdiv_rn(s[3][j], cnt);
        const float var_g = __fsub_rn(corr_gg, __fmul_rn(mean_g, mean_g));
        const float cov_gp = __fsub_rn(corr_gp, __fmul_rn(mean_g, mean_p));
        out_a[j] = __fdiv_rn(cov_gp, __fadd_rn(var_g, io.p.gf_eps));
        out_b[j] = __fsub_rn(mean_p, __fmul_rn(out_a[j], mean_g));
    }
    __syncthreads();                             // ost overwrites the runs' sums
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
        ost[row * kStageStride + col0 + j] = out_a[j];
        ost[(kTileH + row) * kStageStride + col0 + j] = out_b[j];
    }
    __syncthreads();
    for (int i = threadIdx.x >> 5; i < kTileH; i += kTileThreads / 32) {
        const int y = t.y0 + i;
        for (int j = threadIdx.x & 31; j < kTileW; j += 32) {
            const int x = t.x0 + j;
            if (t.writes(y, x)) {
                const long long px = t.n * t.P + static_cast<long long>(y) * t.W + x;
                io.ab[px] = ost[i * kStageStride + j];
                io.ab[total + px] = ost[(kTileH + i) * kStageStride + j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The last pass, refine_recover: with refine, a and b with a gf_r-halo ->
// vertical then horizontal sums -> means -> t = clip(mean_a * g + mean_b,
// 0, 1); without, t = t_raw; in the output dtype. Where Io::kRecover, J =
// clip((I - A)/max(t, t0) + A)^gamma too, from the tile's wire rows (copied
// while the sums run) and the frame's a_seq.
// ---------------------------------------------------------------------------

// B1 (kRecover, refine_recover) and B7 (refine_tmap: no wire rows, no J):
// the frames' float32 planes, the closed-form count; t over the frame.
template <int kIn, int kOut, bool kJ>
struct FrameRefine {
    const void* img;
    const float* t_raw;
    const float* g;
    const float* ab;
    const float* a_seq;
    void* J;
    void* t_out;
    DehazeParams p;
    static constexpr bool kMasked = false, kRecover = kJ;
    static constexpr int kInDt = kIn, kOutDt = kOut;

    __host__ __device__ __forceinline__ static int wire_bytes(const DehazeParams& q) {
        return kJ ? recover_wire_bytes(q) : 0;
    }
    __device__ __forceinline__ Tile tile(int r) const { return this_tile(p, r); }
    __device__ __forceinline__ long long planes() const {
        return static_cast<long long>(p.H) * p.W * p.L * p.B;
    }
    __device__ __forceinline__ void stage_gt(float* gt, const Tile& t) const {
        copy_window(p.refine ? g : t_raw, 0, 1, gt, t, t.y0, t.x0, kTileH, kTileW);
    }
    __device__ __forceinline__ void store_t(const Tile& t, int y, int x, float v) const {
        store_out<kOut>(t_out, t.n * t.P + static_cast<long long>(y) * p.W + x, v);
    }
};

// B9 (halo_refine_tmap): the extended a, b masked to +0 and the guide
// (dtype kG), masked_count's divisor; t over the (N, h, w) core, the
// core's t_raw without refine.
template <int kG, int kOut>
struct HaloRefine {
    const float* t_core;
    const void* g;
    const float* ab;
    const uint8_t* vh;
    const uint8_t* vw;
    void* t_out;
    HaloParams p;
    static constexpr bool kMasked = true, kRecover = false;

    __host__ __device__ __forceinline__ static int wire_bytes(const HaloParams&) { return 0; }
    __device__ __forceinline__ Tile tile(int r) const { return halo_tile(sums_region(p, 0), p, r); }
    __device__ __forceinline__ long long planes() const {
        return static_cast<long long>(ext_h(p)) * ext_w(p) * p.N;
    }
    __device__ __forceinline__ void stage_gt(float* gt, const Tile& t) const {
        if (p.refine) {
            stage_plane<kG>(g, gt, t, t.y0, t.x0, kTileH, kTileW);
        } else {
            Tile core = t;                       // the (N, h, w) plane of t_core
            core.P = static_cast<long long>(p.h) * p.w;
            core.H = p.h;
            core.W = p.w;
            copy_window(t_core, 0, 1, gt, core, t.y0 - p.halo_h, t.x0 - p.halo_w, kTileH,
                        kTileW);
        }
    }
    __device__ __forceinline__ void store_t(const Tile& t, int y, int x, float v) const {
        store_out<kOut>(t_out, (t.n * p.h + y - p.halo_h) * p.w + x - p.halo_w, v);
    }
};

// grid as tmap_tile over the pass's region, Io's shared memory
// (recover_smem, refine_tmap_smem, halo_refine_smem).
template <class Io>
__global__ void __launch_bounds__(kTileThreads) refine_recover_kernel(const Io io) {
    extern __shared__ __align__(16) uint8_t smem_bytes[];
    __shared__ int off[kTileH];
    const auto& p = io.p;
    const int r = p.gf_radius;
    const Tile t = io.tile(r);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint8_t* wire = smem_bytes;                  // [kTileH][row_bytes], kRecover only
    float* gt = reinterpret_cast<float*>(smem_bytes + Io::wire_bytes(p));   // [kTileH][kTileW]
    float* smem = gt + kTileH * kTileW;
    float* tst = smem;                           // [kTileH][kStageStride]: mean_a, then t
    float* mb = smem + kTileH * kStageStride;    // [kTileH][kStageStride]: mean_b
    if constexpr (Io::kRecover)
        copy_wire_rows(io.img, wire, off, t, t.y0, t.x0, kTileH, kTileW,
                       wire_row_bytes(kTileW, elem_bytes(Io::kInDt)), p);
    io.stage_gt(gt, t);
    if (p.refine) {
        const int rows = halo_rows(r), cols = halo_cols(r), vstride = run_stride(r);
        float* in = smem;                        // a, b: [2][rows][cols]
        float2* vs = reinterpret_cast<float2*>(runs_overlay(r) ? smem : smem + in_floats(2, r));
        int* pr = reinterpret_cast<int*>(smem + planes_and_runs(2, 2, r));   // masked: counts
        int* pc = pr + rows + 1;
        copy_window(io.ab, io.planes(), 2, in, t, t.yi, t.xi, rows, cols);
        if constexpr (Io::kMasked) mask_counts(pr, pc, t, r, io.vh, io.vw);
        cp_async_wait();
        __syncthreads();
        if constexpr (Io::kMasked) {
            if (!all_valid(pr, pc, r)) {
                mask_window(in, 2, r, pr, pc, 0.0f);
                __syncthreads();
            }
        }
        vertical_runs<2>(
            r,
            [&](int it, float (&s)[2][kRunV]) {
                const int c = it % cols, row0 = (it / cols) * kRunV;
                window_run<2, kRunV, true>(
                    [&](int k, float (&v)[2]) {
                        const int e = (row0 + k) * cols + c;
                        v[0] = in[e];
                        v[1] = in[rows * cols + e];
                    },
                    2 * r, s);
            },
            [&](int it, const float (&s)[2][kRunV]) {
                const int c = it % cols, row0 = (it / cols) * kRunV;
#pragma unroll
                for (int j = 0; j < kRunV; ++j)
                    vs[(row0 + j) * vstride + c] = make_float2(s[0][j], s[1][j]);
            });
        __syncthreads();
        const int row = threadIdx.x % kTileH, col0 = (threadIdx.x / kTileH) * kRunH;
        const float2* vrow = vs + row * vstride + col0;
        float s[2][kRunH];
        window_run<2, kRunH, true>(
            [&](int k, float (&v)[2]) {
                const float2 f = vrow[k];
                v[0] = f.x;
                v[1] = f.y;
            },
            2 * r, s);
        const float cnt_y = static_cast<float>(win_count(t.y0 + row, t.H, r));
        float mean_a[kRunH], mean_b[kRunH];
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
            float cnt;
            if constexpr (Io::kMasked)
                cnt = mask_count(pr, pc, row, col0 + j, r);
            else
                cnt = __fmul_rn(cnt_y, static_cast<float>(win_count(t.x0 + col0 + j, t.W, r)));
            mean_a[j] = __fdiv_rn(s[0][j], cnt);
            mean_b[j] = __fdiv_rn(s[1][j], cnt);
        }
        __syncthreads();                         // tst, mb overwrite the runs' sums
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
            tst[row * kStageStride + col0 + j] = mean_a[j];
            mb[row * kStageStride + col0 + j] = mean_b[j];
        }
    } else {
        cp_async_wait();
    }
    __syncthreads();
    for (int i = warp; i < kTileH; i += kTileThreads / 32) {
        const int y = t.y0 + i;
        for (int j = lane; j < kTileW; j += 32) {
            const int x = t.x0 + j;
            if (t.writes(y, x)) {
                const float gv = gt[i * kTileW + j];
                const float tv = p.refine
                    ? clip01(__fadd_rn(__fmul_rn(tst[i * kStageStride + j], gv),
                                       mb[i * kStageStride + j]))
                    : gv;
                io.store_t(t, y, x, tv);
                tst[i * kStageStride + j] = tv;
            }
        }
    }
    if constexpr (Io::kRecover) {
        __syncthreads();
        const int es = elem_bytes(Io::kInDt), row_bytes = wire_row_bytes(kTileW, es);
        const float A[3] = {io.a_seq[3 * t.n], io.a_seq[3 * t.n + 1], io.a_seq[3 * t.n + 2]};
        for (int i = warp; i < kTileH; i += kTileThreads / 32) {
            const int y = t.y0 + i;
            if (y >= p.H) break;
            const long long el0 = 3 * (t.n * t.P + static_cast<long long>(y) * p.W + t.x0);
            const uint8_t* w = wire + i * row_bytes + off[i];
            for (int j = lane; j < kTileW; j += 32) {
                if (t.x0 + j >= p.W) break;
                const float tt = fmaxf(tst[i * kStageStride + j], p.t0);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float xv = staged_px<Io::kInDt>(w + 3 * es * j, c, p.u8_scale);
                    float v = clip01(__fadd_rn(__fdiv_rn(__fsub_rn(xv, A[c]), tt), A[c]));
                    if (p.gamma != 1.0f) v = powf(v, p.gamma);
                    store_out<Io::kOutDt>(io.J, el0 + 3 * j + c, v);
                }
            }
        }
    }
}

inline dim3 tile_grid(const DehazeParams& p) {
    return dim3(static_cast<unsigned>((p.W + kTileW - 1) / kTileW),
                static_cast<unsigned>((p.H + kTileH - 1) / kTileH),
                static_cast<unsigned>(p.L * p.B));
}

inline dim3 region_grid(const Region& rg, int planes) {
    return dim3(static_cast<unsigned>((rg.x1 - rg.ox + kTileW - 1) / kTileW),
                static_cast<unsigned>((rg.y1 - rg.y0 + kTileH - 1) / kTileH),
                static_cast<unsigned>(planes));
}

// Opts a kernel in to `bytes` of dynamic shared memory above 48 KB, with
// the SM's largest shared-memory carveout so that as many blocks fit as the
// bytes allow; cudaErrorInvalidValue above what a block may use.
template <class Kernel>
cudaError_t smem_opt_in(Kernel kernel, size_t bytes) {
    if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    if (bytes <= 48 * 1024) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// Launches a tiled pass on io; cudaErrorInvalidValue, launching nothing,
// where its tile and halo need more shared memory than a block has.
template <class Io>
int launch_tiled(void (*kernel)(const Io), const Io& io, dim3 grid, size_t smem,
                 void* stream) {
    const cudaError_t e = smem_opt_in(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(io);
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM of a tiled pass, from the occupancy calculator.
template <class Io>
cudaError_t tiled_blocks(void (*kernel)(const Io), size_t smem, int* blocks) {
    cudaError_t e = smem_opt_in(kernel, smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kTileThreads, smem);
    return e;
}

// f(std::integral_constant<int, dt>{}) for a dtype code 0 <= dt < n (the
// last code for any other): a call's dtypes pick a kernel's instantiation.
template <int n, class F>
int with_dtype(int dt, const F& f) {
    if constexpr (n == 1)
        return f(std::integral_constant<int, 0>{});
    else
        return dt == n - 1 ? f(std::integral_constant<int, n - 1>{}) : with_dtype<n - 1>(dt, f);
}

// Whether the top-k merges take n_lists ascending lists of kk keys a frame
// for a top-k of k over frames of flat_lists top-k tiles: topk_block's lists
// at k > 1; at k = 1 single keys of any tiling (a frame's smallest key
// needs no list number), at most kTopkMaxLists of them.
inline bool lists_ok(int n_lists, int kk, int flat_lists, int k) {
    return n_lists >= 1 && n_lists <= kTopkMaxLists &&
           (k == 1 ? kk == 1 : n_lists == flat_lists && kk == tile_keep(k));
}

inline dim3 threads_grid(long long total) {
    return dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
}

inline long long ext_pixels(const HaloParams& p) {
    return static_cast<long long>(p.h + 2 * p.halo_h) * (p.w + 2 * p.halo_w) * p.N;
}

inline dim3 pixel_grid(const DehazeParams& p) {
    const long long total = static_cast<long long>(p.H) * p.W * p.L * p.B;
    return dim3(static_cast<unsigned>((total + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

int fd_tile_pixels() { return kTopkTile; }
int fd_max_tiles() { return kTopkMaxLists; }

int fd_premap(const void* img, const float* carry_f, float* pre, float* g,
              const DehazeParams* p, void* stream) {
    premap_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, carry_f, pre, g, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_min_rows(const float* x, float* y, const DehazeParams* p, void* stream) {
    min_rows_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, y, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_min_cols_tmap(const float* x, float* t, const DehazeParams* p, void* stream) {
    min_cols_tmap_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, t, *p);
    return static_cast<int>(cudaGetLastError());
}

// t_raw (N, H, W) float32 -> keys (N, n_tiles, min(topk, kTopkTile)).
int fd_topk_block(const float* t, unsigned long long* keys, const DehazeParams* p,
                  void* stream) {
    const long long P = static_cast<long long>(p->H) * p->W;
    const dim3 grid(static_cast<unsigned>((P + kTopkTile - 1) / kTopkTile),
                    static_cast<unsigned>(p->L * p->B));
    topk_block_kernel<<<grid, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t, 0, keys, P, tile_keep(p->topk));
    return static_cast<int>(cudaGetLastError());
}

// keys (N, n_lists, kk): topk_block's lists, or at topk 1 tmap_tile's tile
// keys (kk = 1) -> cand (N, 3) in cand_dt (0 float32, 1 bfloat16), and t_min
// (N,) float32 unless null.
int fd_topk_merge(const unsigned long long* keys, int n_lists, int kk, const void* img,
                  void* cand, int cand_dt, float* t_min, const DehazeParams* p,
                  void* stream) {
    const long long P = static_cast<long long>(p->H) * p->W;
    if (!lists_ok(n_lists, kk, static_cast<int>((P + kTopkTile - 1) / kTopkTile), p->topk))
        return static_cast<int>(cudaErrorInvalidValue);
    topk_merge_kernel<<<p->L * p->B, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, n_lists, kk, p->topk, img, p->in_dtype, p->u8_scale, P, cand, cand_dt, t_min);
    return static_cast<int>(cudaGetLastError());
}

int fd_ema(const float* cand, const int* ids, const float* carry_f, const int* carry_i,
           float* a_seq, float* carry_f_out, int* carry_i_out, const DehazeParams* p,
           void* stream) {
    ema_kernel<<<(p->L + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        cand, ids, carry_f, carry_i, a_seq, carry_f_out, carry_i_out, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_box_rows4(const float* g, const float* t, float* out, const DehazeParams* p,
                 void* stream) {
    box_rows4_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        g, t, out, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_box_cols_ab(const float* rows, float* ab, const DehazeParams* p, void* stream) {
    box_cols_ab_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, ab, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_box_rows2(const float* ab, float* out, const DehazeParams* p, void* stream) {
    box_rows2_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ab, out, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_recover(const void* img, const float* t_raw, const float* g, const float* ab_rows,
               const float* a_seq, void* J, void* t_out, const DehazeParams* p,
               void* stream) {
    recover_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        img, t_raw, g, ab_rows, a_seq, J, t_out, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_tmap(const float* t_raw, const float* g, const float* ab_rows, void* t_out,
            const DehazeParams* p, void* stream) {
    tmap_kernel<<<pixel_grid(*p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t_raw, g, ab_rows, t_out, *p);
    return static_cast<int>(cudaGetLastError());
}

// The tiled passes (B1, B7, B9). Each returns cudaErrorInvalidValue,
// launching nothing, where its tile and halo need more shared memory than a
// block has: fd_tiled_fits, fd_transmission_tiled_fits and
// fd_halo_tiled_fits say beforehand whether a sequence's passes all fit.

int fd_tile_h() { return kTileH; }
int fd_tile_w() { return kTileW; }
int fd_guided_min_blocks() { return kGuidedMinBlocks; }

// 1 where every tiled pass that p runs fits a block's shared memory, else
// 0: from radius 37 with float32 frames (53 bfloat16, 67 uint8), or with
// refine from gf_radius 46. The caller then runs the ten passes, which take
// any radius.
int fd_tiled_fits(const DehazeParams* p) {
    const size_t most = static_cast<size_t>(kMaxSmem);
    return tmap_smem(*p) <= most && (!p->refine || guided_smem(*p) <= most) &&
           recover_smem(*p) <= most && sizeof(float) * 3 * p->B <= most;
}

// img (L, B, H, W, 3) -> t_raw, g (refine; else null) (L*B, H, W) float32,
// and at topk 1 keys (L*B, tiles_y * tiles_x) (else null).
int fd_tmap_tile(const void* img, const float* carry_f, float* t_raw, float* g,
                 unsigned long long* keys, const DehazeParams* p, void* stream) {
    return with_dtype<3>(p->in_dtype, [&](auto in) {
        constexpr int kIn = decltype(in)::value;
        return launch_tiled(tmap_tile_kernel<FrameTmap<kIn>>,
                            FrameTmap<kIn>{img, carry_f, t_raw, g, keys, *p}, tile_grid(*p),
                            tmap_smem(*p), stream);
    });
}

// keys (tmap_tile's at topk 1, topk_block's above) -> a_seq (L, B, 3),
// carry_f' (L, 3), carry_i' (L, 2).
int fd_select_ema(const unsigned long long* keys, const void* img, const int* ids,
                  const float* carry_f, const int* carry_i, float* a_seq, float* carry_f_out,
                  int* carry_i_out, const DehazeParams* p, void* stream) {
    const long long P = static_cast<long long>(p->H) * p->W;
    const int n_lists = p->topk == 1
        ? static_cast<int>(tile_grid(*p).x * tile_grid(*p).y)
        : static_cast<int>((P + kTopkTile - 1) / kTopkTile);
    if (p->topk > 1 && n_lists > kTopkMaxLists) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * 3 * p->B;
    const cudaError_t e = smem_opt_in(select_ema_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    select_ema_kernel<<<p->L, kTopkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        keys, n_lists, p->topk == 1 ? 1 : tile_keep(p->topk), img, ids, carry_f, carry_i,
        a_seq, carry_f_out, carry_i_out, *p);
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM of tmap_tile, guided_ab and refine_recover for p (their
// registers and shared memory), into blocks[0..3).
int fd_tiled_occupancy(const DehazeParams* p, int* blocks) {
    return with_dtype<3>(p->in_dtype, [&](auto in) {
        constexpr int kIn = decltype(in)::value;
        return with_dtype<2>(p->out_dtype, [&](auto out) {
            constexpr int kOut = decltype(out)::value;
            cudaError_t e = tiled_blocks(tmap_tile_kernel<FrameTmap<kIn>>, tmap_smem(*p),
                                         &blocks[0]);
            if (e == cudaSuccess)
                e = tiled_blocks(guided_ab_kernel<FrameGuided>, guided_smem(*p), &blocks[1]);
            if (e == cudaSuccess)
                e = tiled_blocks(refine_recover_kernel<FrameRefine<kIn, kOut, true>>,
                                 recover_smem(*p), &blocks[2]);
            return static_cast<int>(e);
        });
    });
}

// g, t_raw (L*B, H, W) -> ab (2, L*B, H, W) float32.
int fd_guided_ab(const float* g, const float* t_raw, float* ab, const DehazeParams* p,
                 void* stream) {
    return launch_tiled(guided_ab_kernel<FrameGuided>, FrameGuided{g, t_raw, ab, *p},
                        tile_grid(*p), guided_smem(*p), stream);
}

// img, t_raw, with refine g and ab, a_seq -> J (L, B, H, W, 3) and t
// (L, B, H, W) in out_dtype.
int fd_refine_recover(const void* img, const float* t_raw, const float* g, const float* ab,
                      const float* a_seq, void* J, void* t_out, const DehazeParams* p,
                      void* stream) {
    return with_dtype<3>(p->in_dtype, [&](auto in) {
        constexpr int kIn = decltype(in)::value;
        return with_dtype<2>(p->out_dtype, [&](auto out) {
            constexpr int kOut = decltype(out)::value;
            return launch_tiled(refine_recover_kernel<FrameRefine<kIn, kOut, true>>,
                                FrameRefine<kIn, kOut, true>{img, t_raw, g, ab, a_seq, J,
                                                             t_out, *p},
                                tile_grid(*p), recover_smem(*p), stream);
        });
    });
}

// The fused transmission stage's tiled sequence (B7): fd_tmap_tile with
// the per-lane saved A for carry_f, fd_topk_block at topk > 1,
// fd_topk_merge, fd_guided_ab (refine), then fd_refine_tmap.

// 1 where every pass of that sequence fits a block (its last pass stages
// no wire rows), and at topk 1 the merge takes the frame's tile keys; else
// 0, and the caller runs the ten passes.
int fd_transmission_tiled_fits(const DehazeParams* p) {
    const size_t most = static_cast<size_t>(kMaxSmem);
    const dim3 grid = tile_grid(*p);
    return tmap_smem(*p) <= most && (!p->refine || guided_smem(*p) <= most) &&
           refine_tmap_smem(*p) <= most &&
           (p->topk > 1 || static_cast<long long>(grid.x) * grid.y <= kTopkMaxLists);
}

// t_raw, with refine g and ab -> t (L, B, H, W) in out_dtype: refine_recover
// without the wire rows and J.
int fd_refine_tmap(const float* t_raw, const float* g, const float* ab, void* t_out,
                   const DehazeParams* p, void* stream) {
    return with_dtype<2>(p->out_dtype, [&](auto out) {
        constexpr int kOut = decltype(out)::value;
        return launch_tiled(refine_recover_kernel<FrameRefine<0, kOut, false>>,
                            FrameRefine<0, kOut, false>{nullptr, t_raw, g, ab, nullptr,
                                                        nullptr, t_out, *p},
                            tile_grid(*p), refine_tmap_smem(*p), stream);
    });
}

// Blocks an SM of the sequence's tmap_tile, guided_ab and refine_tmap.
int fd_transmission_occupancy(const DehazeParams* p, int* blocks) {
    return with_dtype<3>(p->in_dtype, [&](auto in) {
        constexpr int kIn = decltype(in)::value;
        return with_dtype<2>(p->out_dtype, [&](auto out) {
            constexpr int kOut = decltype(out)::value;
            cudaError_t e = tiled_blocks(tmap_tile_kernel<FrameTmap<kIn>>, tmap_smem(*p),
                                         &blocks[0]);
            if (e == cudaSuccess)
                e = tiled_blocks(guided_ab_kernel<FrameGuided>, guided_smem(*p), &blocks[1]);
            if (e == cudaSuccess)
                e = tiled_blocks(refine_recover_kernel<FrameRefine<0, kOut, false>>,
                                 refine_tmap_smem(*p), &blocks[2]);
            return static_cast<int>(e);
        });
    });
}

// The halo form (B9). vh (h + 2 halo_h,) and vw (w + 2 halo_w,) are
// validity bytes; planes are (N, h_ext, w_ext) unless named core.

int fd_halo_min_rows(const void* pre, const uint8_t* vh, const uint8_t* vw, float* out,
                 const HaloParams* p, void* stream) {
    halo_min_rows_kernel<<<threads_grid(ext_pixels(*p)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(pre, vh, vw, out, *p);
    return static_cast<int>(cudaGetLastError());
}

// rows -> t_raw on the extended plane and its core (N, h, w).
int fd_halo_min_cols_tmap(const float* rows, float* t_ext, float* t_core,
                      const HaloParams* p, void* stream) {
    halo_min_cols_tmap_kernel<<<threads_grid(ext_pixels(*p)), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(rows, t_ext, t_core,
                                                                     *p);
    return static_cast<int>(cudaGetLastError());
}

// t_core (N, h, w) -> keys (N, n_tiles, min(topk, kTopkTile)).
int fd_halo_topk_block(const float* t_core, unsigned long long* keys, const HaloParams* p,
                   void* stream) {
    const long long P = static_cast<long long>(p->h) * p->w;
    const dim3 grid(static_cast<unsigned>((P + kTopkTile - 1) / kTopkTile),
                    static_cast<unsigned>(p->N));
    topk_block_kernel<<<grid, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t_core, 0, keys, P, tile_keep(p->topk));
    return static_cast<int>(cudaGetLastError());
}

// keys (N, n_lists, kk): halo_topk_block's lists, or at topk 1
// halo_tmap_tile's tile keys (kk = 1); img (N, h, w, 3) -> tk_t (N, k)
// float32, tk_rgb (N, k, 3) out_dtype, tk_idx (N, k) int32.
int fd_halo_topk_list(const unsigned long long* keys, int n_lists, int kk, const void* img,
                      float* tk_t, void* tk_rgb, int* tk_idx, const HaloParams* p,
                      void* stream) {
    const long long P = static_cast<long long>(p->h) * p->w;
    if (p->topk < 1 || p->topk > P ||
        !lists_ok(n_lists, kk, static_cast<int>((P + kTopkTile - 1) / kTopkTile), p->topk))
        return static_cast<int>(cudaErrorInvalidValue);
    topk_list_kernel<<<p->N, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, n_lists, kk, p->topk, img, p->in_dtype, p->u8_scale, P,
        tk_t, tk_rgb, p->out_dtype, tk_idx);
    return static_cast<int>(cudaGetLastError());
}

int fd_halo_box_rows4(const void* g, const float* t_ext, const uint8_t* vh, const uint8_t* vw,
                  float* out, const HaloParams* p, void* stream) {
    halo_box_rows4_kernel<<<threads_grid(ext_pixels(*p)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, t_ext, vh, vw, out, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_halo_box_cols_ab(const float* rows, const uint8_t* vh, const uint8_t* vw, float* ab,
                    const HaloParams* p, void* stream) {
    halo_box_cols_ab_kernel<<<threads_grid(ext_pixels(*p)), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(rows, vh, vw, ab, *p);
    return static_cast<int>(cudaGetLastError());
}

int fd_halo_box_rows2(const float* ab, const uint8_t* vh, const uint8_t* vw, float* out,
                  const HaloParams* p, void* stream) {
    halo_box_rows2_kernel<<<threads_grid(ext_pixels(*p)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(ab, vh, vw, out, *p);
    return static_cast<int>(cudaGetLastError());
}

// t_core (N, h, w) and, with refine, the guide and the a/b row sums -> t
// (N, h, w) in out_dtype.
int fd_halo_tmap(const float* t_core, const void* g, const float* ab_rows, const uint8_t* vh,
             const uint8_t* vw, void* t_out, const HaloParams* p, void* stream) {
    halo_tmap_kernel<<<threads_grid(static_cast<long long>(p->h) * p->w * p->N), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(t_core, g, ab_rows, vh, vw,
                                                               t_out, *p);
    return static_cast<int>(cudaGetLastError());
}

// The halo form's tiled sequence: fd_halo_tmap_tile, fd_halo_topk_block at
// topk > 1, fd_halo_topk_list, fd_halo_guided_ab (refine), then
// fd_halo_refine_tmap.

// 1 where every pass of that sequence fits a block, and at topk 1 the list
// merge takes the region's tile keys; else 0, and the caller runs the ten
// masked passes: from radius 89, or with refine from gf_radius 46.
int fd_halo_tiled_fits(const HaloParams* p) {
    const size_t most = static_cast<size_t>(kMaxSmem);
    const dim3 grid = region_grid(halo_region(*p, tmap_margin(*p)), 1);
    return halo_tmap_smem(*p) <= most && (!p->refine || halo_guided_smem(*p) <= most) &&
           halo_refine_smem(*p) <= most &&
           (p->topk > 1 || static_cast<long long>(grid.x) * grid.y <= kTopkMaxLists);
}

// pre (N, h_ext, w_ext) -> t_ext (N, h_ext, w_ext), written on core +-
// 2 gf_r (the core without refine), t_core (N, h, w), and at topk 1 keys
// (N, tiles_y * tiles_x) over that region (else null).
int fd_halo_tmap_tile(const void* pre, const uint8_t* vh, const uint8_t* vw, float* t_ext,
                      float* t_core, unsigned long long* keys, const HaloParams* p,
                      void* stream) {
    const dim3 grid = region_grid(halo_region(*p, tmap_margin(*p)), p->N);
    return with_dtype<2>(p->pre_dtype, [&](auto dt) {
        constexpr int kPre = decltype(dt)::value;
        return launch_tiled(tmap_tile_kernel<HaloTmap<kPre>>,
                            HaloTmap<kPre>{pre, vh, vw, t_ext, t_core, keys, *p}, grid,
                            halo_tmap_smem(*p), stream);
    });
}

// guide, t_ext (N, h_ext, w_ext) -> ab (2, N, h_ext, w_ext) float32, written
// on core +- gf_r.
int fd_halo_guided_ab(const void* g, const float* t_ext, const uint8_t* vh, const uint8_t* vw,
                      float* ab, const HaloParams* p, void* stream) {
    const dim3 grid = region_grid(sums_region(*p, p->gf_radius), p->N);
    return with_dtype<2>(p->guide_dtype, [&](auto dt) {
        constexpr int kG = decltype(dt)::value;
        return launch_tiled(guided_ab_kernel<HaloGuided<kG>>,
                            HaloGuided<kG>{g, t_ext, vh, vw, ab, *p}, grid,
                            halo_guided_smem(*p), stream);
    });
}

// t_core (N, h, w) and, with refine, the guide and ab -> t (N, h, w) in
// out_dtype.
int fd_halo_refine_tmap(const float* t_core, const void* g, const float* ab,
                        const uint8_t* vh, const uint8_t* vw, void* t_out,
                        const HaloParams* p, void* stream) {
    const dim3 grid = region_grid(sums_region(*p, 0), p->N);
    return with_dtype<2>(p->guide_dtype, [&](auto dt) {
        constexpr int kG = decltype(dt)::value;
        return with_dtype<2>(p->out_dtype, [&](auto out) {
            constexpr int kOut = decltype(out)::value;
            return launch_tiled(refine_recover_kernel<HaloRefine<kG, kOut>>,
                                HaloRefine<kG, kOut>{t_core, g, ab, vh, vw, t_out, *p}, grid,
                                halo_refine_smem(*p), stream);
        });
    });
}

// Blocks an SM of halo_tmap_tile, halo_guided_ab and halo_refine_tmap.
int fd_halo_occupancy(const HaloParams* p, int* blocks) {
    return with_dtype<2>(p->pre_dtype, [&](auto pd) {
        constexpr int kPre = decltype(pd)::value;
        return with_dtype<2>(p->guide_dtype, [&](auto gd) {
            constexpr int kG = decltype(gd)::value;
            return with_dtype<2>(p->out_dtype, [&](auto out) {
                constexpr int kOut = decltype(out)::value;
                cudaError_t e = tiled_blocks(tmap_tile_kernel<HaloTmap<kPre>>,
                                             halo_tmap_smem(*p), &blocks[0]);
                if (e == cudaSuccess)
                    e = tiled_blocks(guided_ab_kernel<HaloGuided<kG>>, halo_guided_smem(*p),
                                     &blocks[1]);
                if (e == cudaSuccess)
                    e = tiled_blocks(refine_recover_kernel<HaloRefine<kG, kOut>>,
                                     halo_refine_smem(*p), &blocks[2]);
                return static_cast<int>(e);
            });
        });
    });
}

}  // extern "C"
