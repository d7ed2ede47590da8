// Fused dehaze megakernel for NVIDIA Hopper (sm_90a): the whole DCP/CAP
// chain for L lanes x B frames, as four tiled passes.
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
// The ten passes that came before stay, for those wide windows, for the
// fused transmission stage (B7) and as the tiled sequence's comparator on
// the card:
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
// The ten passes also make up the fused transmission stage of the
// data-parallel sharded step, fused_transmission_pallas /
// fused_transmission_lanes_pallas (body _fused_tmap_kernel): the same
// passes up to the guided filter, the merge writing the candidate in the
// output dtype with t_min, then fd_tmap writing the refined t; no EMA and
// no recovery (the candidates cross ranks first).
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
// pre-map crossed the ranks. Its own kernels, counted apart from B1's and
// B7's, so neither of those changes:
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
// rest, so on a tile of a frame the core's t_raw, t and keys are B7's on
// that frame bit for bit.
//
// The transmission stage and the halo form keep the one-thread-a-pixel
// passes: every intermediate plane round-trips through L2/HBM and each
// window pass loops over 2r+1 values per output. The halo form must read
// the core frames and both extended planes once and write t: for a 2x2 tile of 32 uint8 frames at 480x640 (core
// 240x320, halo 47, float32 planes of 334x414) 52.6 MB, >= 16 us; it
// computes every pass on the whole extended plane, 1.8x the core's pixels.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns the cudaError_t of its launches (0 on success).

#include "dehaze_common.cuh"

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

// t_raw from the windowed min of the pre-map.
__device__ __forceinline__ float tmap_of(float m, const DehazeParams& p) {
    return p.algorithm == 0 ? __fsub_rn(1.0f, __fmul_rn(p.omega, m))
                            : expf(__fmul_rn(p.neg_beta, m));
}

// One step of Eq. 9 (exactly _ema_step's semantics) for frame id fid with
// candidate cand[0..3): updates the lane's A, last update k and inited;
// a_out[0..3) = A after the step.
__device__ __forceinline__ void ema_step(float (&A)[3], int& k, int& inited,
                                         const float* __restrict__ cand, int fid,
                                         float* __restrict__ a_out, const DehazeParams& p) {
    const bool valid = fid >= 0;
    const bool bootstrap = valid && inited == 0;
    // int32 difference wraps, as in the reference.
    const int gap = static_cast<int>(static_cast<unsigned>(fid) - static_cast<unsigned>(k));
    const bool upd = valid && (bootstrap || gap >= p.period);
    for (int c = 0; c < 3; ++c) {
        const float cv = cand[c];
        const float target = bootstrap ? cv
            : __fadd_rn(__fmul_rn(p.lam, cv), __fmul_rn(p.one_minus_lam, A[c]));
        if (upd) A[c] = target;
        a_out[c] = A[c];
    }
    if (upd) k = fid;
    inited = max(inited, valid ? 1 : 0);
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
        ema_step(A, k, inited, cand + 3 * n, ids[n], a_seq + 3 * n, p);
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
// index). The head merge of topk_merge_kernel, writing rows instead of a sum.
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
            ++head[idx / kTopkTile];             // list j is tile j
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
// The tiled passes (B1): one block a kTileH x kTileW output tile of one
// frame, its inputs with their window halo in shared memory.
// ---------------------------------------------------------------------------

constexpr int kTileH = 32;                       // output rows of a tile
constexpr int kTileW = 64;                       // output columns of a tile
constexpr int kTileThreads = 256;
constexpr int kRunV = 16;                        // vertical window outputs a thread
constexpr int kRunVMin = 8;                      // the same for tmap_tile's narrower window
constexpr int kRunH = 8;                         // horizontal window outputs a thread
static_assert(kTileH % kRunV == 0 && kTileH % kRunVMin == 0 && kTileW % kRunH == 0,
              "whole runs a tile");
static_assert(kTileH * (kTileW / kRunH) == kTileThreads, "one horizontal run a thread");
static_assert(kTileH % 32 == 0, "a warp's lanes are 32 rows of a tile in the horizontal runs");

// Shared memory of the tiled passes. A tile's inputs span (kTileH + 2r) x
// (kTileW + 2r) of its frame; regions are reused once spent.
__host__ __device__ __forceinline__ int halo_rows(int r) { return kTileH + 2 * r; }
__host__ __device__ __forceinline__ int halo_cols(int r) { return kTileW + 2 * r; }
__host__ __device__ __forceinline__ int run_stride(int r) { return halo_cols(r) | 1; }
constexpr int kStageStride = kTileW + 1;         // a staged output row

__host__ __device__ __forceinline__ int max_i(int a, int b) { return a > b ? a : b; }

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
__host__ __device__ __forceinline__ int recover_wire_bytes(const DehazeParams& p) {
    return kTileH * wire_row_bytes(kTileW, elem_bytes(p.in_dtype));
}

inline size_t recover_smem(const DehazeParams& p) {
    const int r = p.gf_radius;
    const size_t planes = p.refine ? planes_and_runs(2, 2, r) : kTileH * kStageStride;
    return recover_wire_bytes(p) + sizeof(float) * (kTileH * kTileW + planes);
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

// Frame plane (n, y, x) of a tile: the frame, its first output row and
// column, and the frame position of halo element (0, 0).
struct Tile {
    long long n, P;
    int y0, x0, yi, xi;
};

__device__ __forceinline__ Tile this_tile(const DehazeParams& p, int r) {
    const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
    return {static_cast<long long>(blockIdx.z), static_cast<long long>(p.H) * p.W,
            y0, x0, y0 - r, x0 - r};
}

// Starts the copies of a rows x cols window of np float32 planes (plane q
// at base + q * plane_stride; window element (0, 0) at frame row y_first,
// column x_first) into dst[q] (rows x cols floats, 16-byte aligned), zero
// off the frame. A warp a row, its lanes along it: 16 bytes a copy where
// the window's columns, the frame width and the planes fall on 4-float
// boundaries (each 4 floats then lie wholly on or off the frame), else 4.
__device__ __forceinline__ void copy_window(const float* __restrict__ base,
                                            long long plane_stride, int np, float* dst,
                                            const Tile& t, int y_first, int x_first, int rows,
                                            int cols, const DehazeParams& p) {
    const int lane = threadIdx.x & 31;
    const bool quad = ((x_first | cols | p.W) & 3) == 0 && (plane_stride & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(base) & 15) == 0;
    const int step = quad ? 4 : 1;
    for (int q = 0; q < np; ++q)
        for (int i = threadIdx.x >> 5; i < rows; i += kTileThreads / 32) {
            const int y = y_first + i;
            const bool row_in = y >= 0 && y < p.H;
            const float* src = base + q * plane_stride + t.n * t.P +
                               static_cast<long long>(row_in ? y : 0) * p.W;
            float* d = dst + (q * rows + i) * cols;
            for (int j = lane * step; j < cols; j += 32 * step) {
                const int x = x_first + j;
                const bool in = row_in && x >= 0 && x < p.W;
                if (quad)
                    cp_async16(d + j, in ? src + x : base, in ? 16 : 0);
                else
                    cp_async4(d + j, in ? src + x : base, in ? 4 : 0);
            }
        }
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

// Pass 1, tmap_tile (premap, min_rows, min_cols_tmap, and topk_block at
// k = 1). grid (tiles_x, tiles_y, L*B), block kTileThreads, tmap_smem bytes:
// the tile's wire rows with an r-halo -> pre-map (+inf off the frame) ->
// vertical then horizontal windowed min -> t_raw; writes t_raw, g (refine)
// and, where keys is given, the tile's smallest (t, flat index) key at
// keys[(n * tiles_y + tile_y) * tiles_x + tile_x]. kIn is p.in_dtype.
template <int kIn>
__global__ void __launch_bounds__(kTileThreads)
tmap_tile_kernel(const void* __restrict__ img, const float* __restrict__ carry_f,
                 float* __restrict__ t_raw, float* __restrict__ g,
                 unsigned long long* __restrict__ keys, DehazeParams p) {
    extern __shared__ __align__(16) uint8_t smem_bytes[];
    __shared__ unsigned long long red[kTileThreads / 32 + 1];
    const int r = p.radius;
    const Tile t = this_tile(p, r);
    const int rows = halo_rows(r), cols = halo_cols(r), vstride = run_stride(r);
    const int es = elem_bytes(kIn), row_bytes = wire_row_bytes(cols, es);
    uint8_t* wire = smem_bytes;                  // [rows][row_bytes]
    float* vmin = reinterpret_cast<float*>(smem_bytes);   // [kTileH][vstride], after wire
    float* pre = reinterpret_cast<float*>(smem_bytes + tmap_wire_bytes(p));   // [rows][cols]
    float* tst = pre;                            // [kTileH][kStageStride], after pre
    int* off = reinterpret_cast<int*>(pre + in_floats(1, r));   // [rows]
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
        const float tv = tmap_of(m[0][j], p);
        tst[row * kStageStride + col0 + j] = tv;
        if (y < p.H && x < p.W) {
            const unsigned long long key =
                make_key(tv, static_cast<unsigned>(static_cast<long long>(y) * p.W + x));
            best = key < best ? key : best;
        }
    }
    if (keys != nullptr) {
        best = block_min_u64<kTileThreads>(best, red);
        if (threadIdx.x == 0)
            keys[(t.n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = best;
    }
    __syncthreads();
    for (int i = warp; i < kTileH; i += kTileThreads / 32) {
        const int yy = t.y0 + i;
        for (int j = lane; j < kTileW; j += 32) {
            const int x = t.x0 + j;
            if (yy < p.H && x < p.W)
                t_raw[t.n * t.P + static_cast<long long>(yy) * p.W + x] = tst[i * kStageStride + j];
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
        ema_step(A, k, inited, cand + 3 * b, ids[n], a_seq + 3 * n, p);
    }
    for (int c = 0; c < 3; ++c) carry_f_out[3 * lane + c] = A[c];
    carry_i_out[2 * lane] = k;
    carry_i_out[2 * lane + 1] = inited;
}

// Pass 3, guided_ab (box_rows4 and box_cols_ab). grid as tmap_tile,
// guided_smem bytes: g and t_raw with a gf_r-halo (zero off the frame) ->
// vertical sums of g, p, g*p, g*g (the products formed as each input is
// fetched) -> horizontal sums -> means over the closed-form count -> a, b,
// written to ab (2, L*B, H, W).
__global__ void __launch_bounds__(kTileThreads, 3)
guided_ab_kernel(const float* __restrict__ g, const float* __restrict__ t_raw,
                 float* __restrict__ ab, DehazeParams p) {
    extern __shared__ __align__(16) float smem[];
    const int r = p.gf_radius;
    const Tile t = this_tile(p, r);
    const int rows = halo_rows(r), cols = halo_cols(r), vstride = run_stride(r);
    const long long total = t.P * p.L * p.B;
    float* in = smem;                            // g, p: [2][rows][cols]
    float4* vs = reinterpret_cast<float4*>(runs_overlay(r) ? smem : smem + in_floats(2, r));
    float* ost = smem;                           // a, b: [2][kTileH][kStageStride], at the end
    copy_window(g, 0, 1, in, t, t.yi, t.xi, rows, cols, p);
    copy_window(t_raw, 0, 1, in + rows * cols, t, t.yi, t.xi, rows, cols, p);
    cp_async_wait();
    __syncthreads();
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
    const float cnt_y = static_cast<float>(win_count(t.y0 + row, p.H, r));
    float out_a[kRunH], out_b[kRunH];
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
        const float cnt = __fmul_rn(cnt_y, static_cast<float>(win_count(t.x0 + col0 + j, p.W, r)));
        const float mean_g = __fdiv_rn(s[0][j], cnt), mean_p = __fdiv_rn(s[1][j], cnt);
        const float corr_gp = __fdiv_rn(s[2][j], cnt), corr_gg = __fdiv_rn(s[3][j], cnt);
        const float var_g = __fsub_rn(corr_gg, __fmul_rn(mean_g, mean_g));
        const float cov_gp = __fsub_rn(corr_gp, __fmul_rn(mean_g, mean_p));
        out_a[j] = __fdiv_rn(cov_gp, __fadd_rn(var_g, p.gf_eps));
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
            if (y < p.H && x < p.W) {
                const long long px = t.n * t.P + static_cast<long long>(y) * p.W + x;
                ab[px] = ost[i * kStageStride + j];
                ab[total + px] = ost[(kTileH + i) * kStageStride + j];
            }
        }
    }
}

// Pass 4, refine_recover (box_rows2 and recover). grid as tmap_tile,
// recover_smem bytes: the tile's wire rows and its guide (refine) or t_raw
// tile are copied while, with refine, a and b with a gf_r-halo -> vertical
// then horizontal sums -> means -> t = clip(mean_a * g + mean_b, 0, 1);
// without, t = t_raw. Then J = clip((I - A)/max(t, t0) + A)^gamma with the
// frame's a_seq, a pixel a thread; J and t in the output dtype. kIn, kOut
// are p.in_dtype, p.out_dtype.
template <int kIn, int kOut>
__global__ void __launch_bounds__(kTileThreads)
refine_recover_kernel(const void* __restrict__ img, const float* __restrict__ t_raw,
                      const float* __restrict__ g, const float* __restrict__ ab,
                      const float* __restrict__ a_seq, void* __restrict__ J,
                      void* __restrict__ t_out, DehazeParams p) {
    extern __shared__ __align__(16) uint8_t smem_bytes[];
    __shared__ int off[kTileH];
    const int r = p.gf_radius;
    const Tile t = this_tile(p, r);
    const int es = elem_bytes(kIn), row_bytes = wire_row_bytes(kTileW, es);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint8_t* wire = smem_bytes;                  // [kTileH][row_bytes]
    float* gt = reinterpret_cast<float*>(smem_bytes + recover_wire_bytes(p));   // [kTileH][kTileW]
    float* smem = gt + kTileH * kTileW;
    float* tst = smem;                           // [kTileH][kStageStride]: mean_a, then t
    float* mb = smem + kTileH * kStageStride;    // [kTileH][kStageStride]: mean_b
    copy_wire_rows(img, wire, off, t, t.y0, t.x0, kTileH, kTileW, row_bytes, p);
    copy_window(p.refine ? g : t_raw, 0, 1, gt, t, t.y0, t.x0, kTileH, kTileW, p);
    if (p.refine) {
        const int rows = halo_rows(r), cols = halo_cols(r), vstride = run_stride(r);
        float* in = smem;                        // a, b: [2][rows][cols]
        float2* vs = reinterpret_cast<float2*>(runs_overlay(r) ? smem : smem + in_floats(2, r));
        copy_window(ab, t.P * p.L * p.B, 2, in, t, t.yi, t.xi, rows, cols, p);
        cp_async_wait();
        __syncthreads();
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
        const float cnt_y = static_cast<float>(win_count(t.y0 + row, p.H, r));
        float mean_a[kRunH], mean_b[kRunH];
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
            const float cnt =
                __fmul_rn(cnt_y, static_cast<float>(win_count(t.x0 + col0 + j, p.W, r)));
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
            if (y < p.H && x < p.W) {
                const float gv = gt[i * kTileW + j];
                const float tv = p.refine
                    ? clip01(__fadd_rn(__fmul_rn(tst[i * kStageStride + j], gv),
                                       mb[i * kStageStride + j]))
                    : gv;
                store_out<kOut>(t_out, t.n * t.P + static_cast<long long>(y) * p.W + x, tv);
                tst[i * kStageStride + j] = tv;
            }
        }
    }
    __syncthreads();
    const float A[3] = {a_seq[3 * t.n], a_seq[3 * t.n + 1], a_seq[3 * t.n + 2]};
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
                const float xv = staged_px<kIn>(w + 3 * es * j, c, p.u8_scale);
                float v = clip01(__fadd_rn(__fdiv_rn(__fsub_rn(xv, A[c]), tt), A[c]));
                if (p.gamma != 1.0f) v = powf(v, p.gamma);
                store_out<kOut>(J, el0 + 3 * j + c, v);
            }
        }
    }
}

// The instantiations for a call's dtypes.
using TmapKernel = void (*)(const void*, const float*, float*, float*, unsigned long long*,
                            DehazeParams);
using RecoverKernel = void (*)(const void*, const float*, const float*, const float*,
                               const float*, void*, void*, DehazeParams);

inline TmapKernel tmap_kernel_for(const DehazeParams& p) {
    return p.in_dtype == 0 ? tmap_tile_kernel<0>
         : p.in_dtype == 1 ? tmap_tile_kernel<1> : tmap_tile_kernel<2>;
}

template <int kIn>
inline RecoverKernel recover_kernel_in(int out_dtype) {
    return out_dtype == 0 ? refine_recover_kernel<kIn, 0> : refine_recover_kernel<kIn, 1>;
}

inline RecoverKernel recover_kernel_for(const DehazeParams& p) {
    return p.in_dtype == 0 ? recover_kernel_in<0>(p.out_dtype)
         : p.in_dtype == 1 ? recover_kernel_in<1>(p.out_dtype) : recover_kernel_in<2>(p.out_dtype);
}

inline dim3 tile_grid(const DehazeParams& p) {
    return dim3(static_cast<unsigned>((p.W + kTileW - 1) / kTileW),
                static_cast<unsigned>((p.H + kTileH - 1) / kTileH),
                static_cast<unsigned>(p.L * p.B));
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

// keys -> cand (N, 3) in cand_dt (0 float32, 1 bfloat16), and t_min (N,)
// float32 unless null.
int fd_topk_merge(const unsigned long long* keys, const void* img, void* cand,
                  int cand_dt, float* t_min, const DehazeParams* p, void* stream) {
    const long long P = static_cast<long long>(p->H) * p->W;
    const int n_lists = static_cast<int>((P + kTopkTile - 1) / kTopkTile);
    if (n_lists > kTopkMaxLists) return static_cast<int>(cudaErrorInvalidValue);
    topk_merge_kernel<<<p->L * p->B, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, n_lists, tile_keep(p->topk), p->topk, img, p->in_dtype, p->u8_scale, P,
        cand, cand_dt, t_min);
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

// The tiled passes (B1). Each returns cudaErrorInvalidValue, launching
// nothing, where its tile and halo need more shared memory than a block has:
// fd_tiled_fits says beforehand whether they all fit.

int fd_tile_h() { return kTileH; }
int fd_tile_w() { return kTileW; }

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
    const size_t smem = tmap_smem(*p);
    const TmapKernel kernel = tmap_kernel_for(*p);
    const cudaError_t e = smem_opt_in(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<tile_grid(*p), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        img, carry_f, t_raw, g, keys, *p);
    return static_cast<int>(cudaGetLastError());
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
    const size_t smem[3] = {tmap_smem(*p), guided_smem(*p), recover_smem(*p)};
    const TmapKernel tmap = tmap_kernel_for(*p);
    const RecoverKernel recover = recover_kernel_for(*p);
    cudaError_t e = smem_opt_in(tmap, smem[0]);
    if (e == cudaSuccess) e = smem_opt_in(guided_ab_kernel, smem[1]);
    if (e == cudaSuccess) e = smem_opt_in(recover, smem[2]);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], tmap, kTileThreads,
                                                          smem[0]);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], guided_ab_kernel,
                                                          kTileThreads, smem[1]);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], recover, kTileThreads,
                                                          smem[2]);
    return static_cast<int>(e);
}

// g, t_raw (L*B, H, W) -> ab (2, L*B, H, W) float32.
int fd_guided_ab(const float* g, const float* t_raw, float* ab, const DehazeParams* p,
                 void* stream) {
    const size_t smem = guided_smem(*p);
    const cudaError_t e = smem_opt_in(guided_ab_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    guided_ab_kernel<<<tile_grid(*p), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        g, t_raw, ab, *p);
    return static_cast<int>(cudaGetLastError());
}

// img, t_raw, with refine g and ab, a_seq -> J (L, B, H, W, 3) and t
// (L, B, H, W) in out_dtype.
int fd_refine_recover(const void* img, const float* t_raw, const float* g, const float* ab,
                      const float* a_seq, void* J, void* t_out, const DehazeParams* p,
                      void* stream) {
    const size_t smem = recover_smem(*p);
    const RecoverKernel kernel = recover_kernel_for(*p);
    const cudaError_t e = smem_opt_in(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<tile_grid(*p), kTileThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        img, t_raw, g, ab, a_seq, J, t_out, *p);
    return static_cast<int>(cudaGetLastError());
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

// keys, img (N, h, w, 3) -> tk_t (N, k) float32, tk_rgb (N, k, 3) out_dtype,
// tk_idx (N, k) int32.
int fd_halo_topk_list(const unsigned long long* keys, const void* img, float* tk_t,
                  void* tk_rgb, int* tk_idx, const HaloParams* p, void* stream) {
    const long long P = static_cast<long long>(p->h) * p->w;
    const int n_lists = static_cast<int>((P + kTopkTile - 1) / kTopkTile);
    if (n_lists > kTopkMaxLists || p->topk < 1 || p->topk > P)
        return static_cast<int>(cudaErrorInvalidValue);
    topk_list_kernel<<<p->N, kTopkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, n_lists, tile_keep(p->topk), p->topk, img, p->in_dtype, p->u8_scale, P,
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

}  // extern "C"
