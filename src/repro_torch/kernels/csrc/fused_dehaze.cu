// Fused dehaze megakernel for NVIDIA Hopper (sm_90a): the whole DCP/CAP
// chain for L lanes x B frames, as a short sequence of passes.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::fused_dehaze_lanes_pallas
// (body _fused_dehaze_kernel -> _dehaze_grid_step -> _frame_tmap,
// _guided_refine, _ema_step), and with it the function of its
// double-buffered body _fused_dehaze_dbuf_kernel (identical results).
// Its passes also make up the fused transmission stage of the data-parallel
// sharded step, fused_transmission_pallas / fused_transmission_lanes_pallas
// (body _fused_tmap_kernel): the same passes up to the guided filter, the
// merge writing the candidate in the output dtype with t_min, then fd_tmap
// writing the refined t; no EMA and no recovery (the candidates cross
// ranks first).
//
// Why passes, not one block per frame: the TPU kernel holds a whole frame
// in VMEM. A 480x640 float32 plane is 1.2 MB and a Hopper block has at
// most 227 KB of shared memory, so the chain is split into passes over all
// L*B frames at once, with the planes between passes in device memory
// (L2 is 50 MB and catches much of it):
//
//   fd_premap        upcast, pre-map (DCP min_c I/A_saved, CAP depth), luma
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
// Only the EMA is sequential: the pre-map of every frame in a batch uses
// the lane's batch-entry saved A, so t and the candidates of all L*B frames
// are independent and run in parallel; the EMA is one short pass after.
//
// Rounding follows the plain PyTorch version (repro_torch/kernels/ref.py)
// one operation at a time: IEEE division and expf (no fast math),
// __fmul_rn/__fadd_rn wherever a multiply-add could be contracted, uint8
// ingest multiplied by float32(1/255). So t_raw and the EMA's A are bit
// identical to it and a selection cannot flip on a 1-ulp difference.
// Window sums are direct sums over the clipped window divided by the
// closed-form in-bounds count (not cumsum differences): the guided filter
// divides var_g = corr_gg - mean_g^2 by var_g + eps, which amplifies
// summation error about 1000x.
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
// What bounds it on the H100: device-memory bytes. At L=4, B=8, 480x640,
// uint8 in and float32 out the function must read 29.5 MB and write
// 118.0 MB (J) + 39.3 MB (t) = 186.8 MB, >= 56 us at 3.35 TB/s (f32 in:
// 275 MB, >= 82 us). This simple design does nothing about that yet: every
// intermediate plane round-trips through L2/HBM and each window pass loops
// over 2r+1 values per output. Fusing the passes into halo tiles is later
// work. The halo form must read the core frames and both extended planes
// once and write t: for a 2x2 tile of 32 uint8 frames at 480x640 (core
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
    float v;
    if (p.algorithm == 0) {
        const int lane = static_cast<int>(i / P / p.B);
        const float* a = carry_f + 3 * lane;
        const float a0r = fmaxf(a[0], p.a_floor);
        const float a0g = fmaxf(a[1], p.a_floor);
        const float a0b = fmaxf(a[2], p.a_floor);
        v = fminf(fminf(__fdiv_rn(r, a0r), __fdiv_rn(gg, a0g)), __fdiv_rn(b, a0b));
    } else {
        const float mx = fmaxf(fmaxf(r, gg), b);
        const float mn = fminf(fminf(r, gg), b);
        const float s = mx > 0.0f ? __fdiv_rn(__fsub_rn(mx, mn), fmaxf(mx, 1e-12f)) : 0.0f;
        v = __fadd_rn(__fadd_rn(p.w0, __fmul_rn(p.w1, mx)), __fmul_rn(p.w2, s));
    }
    pre[i] = v;
    if (g != nullptr)
        g[i] = __fadd_rn(__fadd_rn(__fmul_rn(p.luma0, r), __fmul_rn(p.luma1, gg)),
                         __fmul_rn(p.luma2, b));
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
    t[i] = p.algorithm == 0 ? __fsub_rn(1.0f, __fmul_rn(p.omega, m))
                            : expf(__fmul_rn(p.neg_beta, m));
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
        const int fid = ids[n];
        const bool valid = fid >= 0;
        const bool bootstrap = valid && inited == 0;
        // int32 difference wraps, as in the reference.
        const int gap = static_cast<int>(static_cast<unsigned>(fid) - static_cast<unsigned>(k));
        const bool upd = valid && (bootstrap || gap >= p.period);
        for (int c = 0; c < 3; ++c) {
            const float cv = cand[3 * n + c];
            const float target = bootstrap ? cv
                : __fadd_rn(__fmul_rn(p.lam, cv), __fmul_rn(p.one_minus_lam, A[c]));
            if (upd) A[c] = target;
            a_seq[3 * n + c] = A[c];
        }
        if (upd) k = fid;
        inited = max(inited, valid ? 1 : 0);
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
