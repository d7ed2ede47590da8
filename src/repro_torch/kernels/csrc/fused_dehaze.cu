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
// What bounds it on the H100: device-memory bytes. At L=4, B=8, 480x640,
// uint8 in and float32 out the function must read 29.5 MB and write
// 118.0 MB (J) + 39.3 MB (t) = 186.8 MB, >= 56 us at 3.35 TB/s (f32 in:
// 275 MB, >= 82 us). This simple design does nothing about that yet: every
// intermediate plane round-trips through L2/HBM and each window pass loops
// over 2r+1 values per output. Fusing the passes into halo tiles is later
// work.
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

}  // extern "C"
