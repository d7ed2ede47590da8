"""The fused dehaze megakernel on Hopper: wrappers, passes and plain passes.

``fused_dehaze_lanes`` is the port of the JAX package's
``kernels/fused.py::fused_dehaze_lanes_pallas`` and ``fused_dehaze`` its
L=1 view (``fused_dehaze_pallas``). On a CUDA tensor the wrapper runs the
hand-written kernels of ``csrc/fused_dehaze.cu`` (see the design note at
the top of that file) and raises if a build or a launch fails; on a CPU
tensor it runs the plain version, ``kernels.ref.fused_dehaze_lanes``.
Nothing falls back from one to the other.

The megakernel is a sequence of passes over all L*B frames. Each pass has
a CUDA wrapper in :data:`CUDA_PASSES` and a plain PyTorch counterpart with
the same signature in :data:`PLAIN_PASSES`; :func:`run_passes` is the one
orchestration both run through, so the CPU tests check the wiring the
card runs, and ``chip_smoke.py`` holds every pass against its plain
counterpart on the card. :data:`launches` counts kernel launches per pass,
each where its kernel launches; every run of the whole sequence launches
``premap`` exactly once, so its count is also the count of whole runs.

The fused transmission stage of the data-parallel sharded step,
``fused_transmission_lanes`` (the port of ``fused_transmission_lanes_pallas``)
and its L=1 view ``fused_transmission`` (``fused_transmission_pallas``),
is the same passes up to the guided filter, then two of its own: the
candidate merge (the megakernel's merge kernel, also writing t_min and the
candidate in the output dtype) and ``tmap`` (the refined t, no J); no EMA,
no recovery. Its passes are :data:`TRANSMISSION_PASSES`, run by
:func:`run_transmission_passes` and counted apart from the megakernel's in
:data:`transmission_launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.staged import (KEY_LAST, TOPK_MAX_TILES, TOPK_TILE,
                                        flip_key_order, key_index, key_t,
                                        topk_keys_signed, topk_mean,
                                        window_counts, window_sum)

SOURCE = "fused_dehaze.cu"

#: Pixels per top-k tile: ``kTopkTile`` in ``csrc/dehaze_common.cuh``
#: (checked at load).
TILE_PIXELS = TOPK_TILE

PASSES = ("premap", "min_rows", "min_cols_tmap", "topk_block", "topk_merge",
          "ema", "box_rows4", "box_cols_ab", "box_rows2", "recover")

TRANSMISSION_PASSES = ("premap", "min_rows", "min_cols_tmap", "topk_block",
                       "candidate", "box_rows4", "box_cols_ab", "box_rows2",
                       "tmap")

#: Kernel launches since the last :func:`reset_launches`, by pass name: of
#: the megakernel, and of the fused transmission stage.
launches: Dict[str, int] = {name: 0 for name in PASSES}
transmission_launches: Dict[str, int] = {name: 0
                                         for name in TRANSMISSION_PASSES}

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for counts in (launches, transmission_launches):
        for k in counts:
            counts[k] = 0


class _Params(ctypes.Structure):
    """Mirror of ``DehazeParams`` in ``csrc/fused_dehaze.cu``."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "L", "B", "H", "W", "in_dtype", "out_dtype", "algorithm", "radius",
        "refine", "gf_radius", "period", "topk")]
        + [(n, ctypes.c_float) for n in (
            "omega", "neg_beta", "w0", "w1", "w2", "luma0", "luma1", "luma2",
            "a_floor", "gf_eps", "t0", "gamma", "lam", "one_minus_lam",
            "u8_scale")])


@dataclasses.dataclass(frozen=True)
class Static:
    """Every static argument of one megakernel call (shapes, dtypes and
    the algorithm's constants)."""
    L: int
    B: int
    H: int
    W: int
    in_dtype: torch.dtype
    out_dtype: torch.dtype
    algorithm: str
    radius: int
    omega: float
    beta: float
    cap_w: Tuple[float, float, float]
    refine: bool
    gf_radius: int
    gf_eps: float
    t0: float
    gamma: float
    period: int
    lam: float
    topk: int

    @property
    def n_frames(self) -> int:
        return self.L * self.B

    def params(self) -> _Params:
        # Python floats are rounded to float32 here, exactly as PyTorch
        # rounds a Python scalar operand of a float32 tensor operation.
        return _Params(
            L=self.L, B=self.B, H=self.H, W=self.W,
            in_dtype=_IN_CODES[self.in_dtype],
            out_dtype=_OUT_CODES[self.out_dtype],
            algorithm=0 if self.algorithm == "dcp" else 1, radius=self.radius,
            refine=int(self.refine), gf_radius=self.gf_radius,
            period=self.period, topk=self.topk, omega=self.omega,
            neg_beta=-self.beta, w0=self.cap_w[0], w1=self.cap_w[1],
            w2=self.cap_w[2], luma0=ref.LUMA_WEIGHTS[0],
            luma1=ref.LUMA_WEIGHTS[1], luma2=ref.LUMA_WEIGHTS[2],
            a_floor=1e-3, gf_eps=self.gf_eps, t0=self.t0, gamma=self.gamma,
            lam=self.lam, one_minus_lam=1.0 - self.lam,
            u8_scale=1.0 / ref.U8_SCALE)


def make_static(img: torch.Tensor, *, algorithm: str = "dcp", radius: int,
                omega: float = 0.95, beta: float = 1.0,
                cap_w: Sequence[float] = ref.CAP_COEFFS, refine: bool,
                gf_radius: int, gf_eps: float, t0: float, gamma: float,
                period: int, lam: float, topk: int = 1,
                out_dtype: Optional[str] = None) -> Static:
    """Validate a (L, B, H, W, 3) wire-dtype batch and the static
    arguments; raise ``ValueError`` on anything the kernel does not take."""
    if img.dim() != 5 or img.shape[-1] != 3:
        raise ValueError(f"expected (L, B, H, W, 3) frames, got {tuple(img.shape)}")
    if img.dtype not in _IN_CODES:
        raise ValueError(f"unsupported frame dtype {img.dtype}")
    if algorithm not in ("dcp", "cap"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    L, B, H, W, _ = img.shape
    if not 1 <= topk <= H * W:
        raise ValueError(f"topk={topk} outside [1, H*W={H * W}]")
    if -(-(H * W) // TILE_PIXELS) > TOPK_MAX_TILES:
        raise ValueError(f"H*W={H * W} needs more than {TOPK_MAX_TILES} "
                         f"top-k tiles of {TILE_PIXELS} pixels")
    if radius < 0 or gf_radius < 0:
        raise ValueError("window radii must be >= 0")
    return Static(L=L, B=B, H=H, W=W, in_dtype=img.dtype,
                  out_dtype=ref.resolve_out_dtype(img.dtype, out_dtype),
                  algorithm=algorithm, radius=radius, omega=omega, beta=beta,
                  cap_w=tuple(float(c) for c in cap_w), refine=bool(refine),
                  gf_radius=gf_radius, gf_eps=gf_eps, t0=t0, gamma=gamma,
                  period=period, lam=lam, topk=topk)


# ---------------------------------------------------------------------------
# The CUDA passes
# ---------------------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/fused_dehaze.cu``."""
    global _lib_handle
    if _lib_handle is None:
        from repro_torch.kernels import _build
        lib = _build.load(SOURCE)
        vp, pp = ctypes.c_void_p, ctypes.POINTER(_Params)
        sigs = {
            "fd_premap": [vp, vp, vp, vp, pp, vp],
            "fd_min_rows": [vp, vp, pp, vp],
            "fd_min_cols_tmap": [vp, vp, pp, vp],
            "fd_topk_block": [vp, vp, pp, vp],
            "fd_topk_merge": [vp, vp, vp, ctypes.c_int, vp, pp, vp],
            "fd_ema": [vp, vp, vp, vp, vp, vp, vp, pp, vp],
            "fd_box_rows4": [vp, vp, vp, pp, vp],
            "fd_box_cols_ab": [vp, vp, pp, vp],
            "fd_box_rows2": [vp, vp, pp, vp],
            "fd_recover": [vp, vp, vp, vp, vp, vp, vp, pp, vp],
            "fd_tmap": [vp, vp, vp, vp, pp, vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for name in ("fd_tile_pixels", "fd_max_tiles"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        got = (lib.fd_tile_pixels(), lib.fd_max_tiles())
        if got != (TILE_PIXELS, TOPK_MAX_TILES):
            raise RuntimeError(f"{SOURCE} top-k tiles {got}, expected "
                               f"{(TILE_PIXELS, TOPK_MAX_TILES)}")
        _lib_handle = lib
    return _lib_handle


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, counts: Dict[str, int], *args,
            kernel: Optional[str] = None) -> None:
    """Call ``fd_<kernel or name>`` on the current stream; count it as
    ``counts[name]``; raise on a non-zero cudaError_t."""
    fn = f"fd_{kernel or name}"
    rc = getattr(_lib(), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed: cudaError_t {rc}")
    counts[name] += 1


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _plane(s: Static, n: int = 0, dtype=torch.float32, device=None):
    shape = (s.n_frames, s.H, s.W) if n == 0 else (n, s.n_frames, s.H, s.W)
    return torch.empty(shape, dtype=dtype, device=device)


def cuda_premap(img, carry_f, s: Static, counts=launches):
    _check_cuda(img, carry_f)
    pre = _plane(s, device=img.device)
    g = _plane(s, device=img.device) if s.refine else None
    p = s.params()
    _launch("premap", counts, img.data_ptr(), carry_f.data_ptr(), pre.data_ptr(),
            _ptr(g), ctypes.byref(p))
    return pre, g


def cuda_min_rows(pre, s: Static, counts=launches):
    _check_cuda(pre)
    out = torch.empty_like(pre)
    p = s.params()
    _launch("min_rows", counts, pre.data_ptr(), out.data_ptr(), ctypes.byref(p))
    return out


def cuda_min_cols_tmap(rows, s: Static, counts=launches):
    _check_cuda(rows)
    t_raw = torch.empty_like(rows)
    p = s.params()
    _launch("min_cols_tmap", counts, rows.data_ptr(), t_raw.data_ptr(), ctypes.byref(p))
    return t_raw


def _tile_keep(s: Static) -> int:
    """Keys a top-k tile keeps (a tile has TILE_PIXELS pixels)."""
    return min(s.topk, TILE_PIXELS)


def cuda_topk_block(t_raw, s: Static, counts=launches):
    """(N, H, W) t_raw -> (N, n_tiles, min(k, TILE_PIXELS)) int64 keys
    (unsigned bits)."""
    _check_cuda(t_raw)
    n_tiles = -(-(s.H * s.W) // TILE_PIXELS)
    keys = torch.empty((s.n_frames, n_tiles, _tile_keep(s)),
                       dtype=torch.int64, device=t_raw.device)
    p = s.params()
    _launch("topk_block", counts, t_raw.data_ptr(), keys.data_ptr(), ctypes.byref(p))
    return keys


def cuda_topk_merge(keys, img, s: Static, counts=launches):
    _check_cuda(keys, img)
    cand = torch.empty((s.n_frames, 3), dtype=torch.float32, device=img.device)
    p = s.params()
    _launch("topk_merge", counts, keys.data_ptr(), img.data_ptr(),
            cand.data_ptr(), _OUT_CODES[torch.float32], None, ctypes.byref(p))
    return cand


def cuda_candidate(keys, img, s: Static, counts=transmission_launches):
    """The merge kernel for the transmission stage: ``(t_min (N,) float32,
    cand (N, 3) in the output dtype)``."""
    _check_cuda(keys, img)
    t_min = torch.empty((s.n_frames,), dtype=torch.float32, device=img.device)
    cand = torch.empty((s.n_frames, 3), dtype=s.out_dtype, device=img.device)
    p = s.params()
    _launch("candidate", counts, keys.data_ptr(), img.data_ptr(),
            cand.data_ptr(), _OUT_CODES[s.out_dtype], t_min.data_ptr(),
            ctypes.byref(p), kernel="topk_merge")
    return t_min, cand


def cuda_ema(cand, ids, carry_f, carry_i, s: Static, counts=launches):
    _check_cuda(cand, ids, carry_f, carry_i)
    dev = cand.device
    a_seq = torch.empty((s.L, s.B, 3), dtype=torch.float32, device=dev)
    cf = torch.empty((s.L, 3), dtype=torch.float32, device=dev)
    ci = torch.empty((s.L, 2), dtype=torch.int32, device=dev)
    p = s.params()
    _launch("ema", counts, cand.data_ptr(), ids.data_ptr(), carry_f.data_ptr(),
            carry_i.data_ptr(), a_seq.data_ptr(), cf.data_ptr(), ci.data_ptr(),
            ctypes.byref(p))
    return a_seq, cf, ci


def cuda_box_rows4(g, t_raw, s: Static, counts=launches):
    _check_cuda(g, t_raw)
    out = _plane(s, 4, device=g.device)
    p = s.params()
    _launch("box_rows4", counts, g.data_ptr(), t_raw.data_ptr(), out.data_ptr(),
            ctypes.byref(p))
    return out


def cuda_box_cols_ab(rows4, s: Static, counts=launches):
    _check_cuda(rows4)
    ab = _plane(s, 2, device=rows4.device)
    p = s.params()
    _launch("box_cols_ab", counts, rows4.data_ptr(), ab.data_ptr(), ctypes.byref(p))
    return ab


def cuda_box_rows2(ab, s: Static, counts=launches):
    _check_cuda(ab)
    out = torch.empty_like(ab)
    p = s.params()
    _launch("box_rows2", counts, ab.data_ptr(), out.data_ptr(), ctypes.byref(p))
    return out


def cuda_recover(img, t_raw, g, rows2, a_seq, s: Static, counts=launches):
    _check_cuda(img, t_raw, a_seq)
    dev = img.device
    J = torch.empty((s.L, s.B, s.H, s.W, 3), dtype=s.out_dtype, device=dev)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype, device=dev)
    p = s.params()
    _launch("recover", counts, img.data_ptr(), t_raw.data_ptr(), _ptr(g), _ptr(rows2),
            a_seq.data_ptr(), J.data_ptr(), t.data_ptr(), ctypes.byref(p))
    return J, t


def cuda_tmap(t_raw, g, rows2, s: Static, counts=transmission_launches):
    """The refined t (t_raw without refine) in the output dtype, no J."""
    _check_cuda(t_raw)
    t = torch.empty((s.L, s.B, s.H, s.W), dtype=s.out_dtype,
                    device=t_raw.device)
    p = s.params()
    _launch("tmap", counts, t_raw.data_ptr(), _ptr(g), _ptr(rows2),
            t.data_ptr(), ctypes.byref(p))
    return t


# ---------------------------------------------------------------------------
# The plain passes (same signatures, any device)
# ---------------------------------------------------------------------------

def _frames(img: torch.Tensor, s: Static) -> torch.Tensor:
    return ref.upcast_frames(img).reshape(s.n_frames, s.H, s.W, 3)


def plain_premap(img, carry_f, s: Static):
    x = _frames(img, s)
    a0 = torch.clamp_min(carry_f.to(torch.float32), 1e-3)
    a0 = a0.repeat_interleave(s.B, 0)[:, None, None, :]
    pre = ref.premap(x, a0, s.algorithm, s.cap_w)
    return pre, (ref.luminance(x) if s.refine else None)


def plain_min_rows(pre, s: Static):
    k = 2 * s.radius + 1
    return -F.max_pool2d(-pre[:, None], (k, 1), stride=1,
                         padding=(s.radius, 0))[:, 0]


def plain_min_cols_tmap(rows, s: Static):
    k = 2 * s.radius + 1
    dark = -F.max_pool2d(-rows[:, None], (1, k), stride=1,
                         padding=(0, s.radius))[:, 0]
    return ref.tmap_from_dark(dark, s.algorithm, s.omega, s.beta)


def plain_topk_block(t_raw, s: Static):
    """Per tile of :data:`TILE_PIXELS` pixels, its k smallest keys in
    ascending order, all-ones where the tile has fewer than k pixels:
    bit for bit what :func:`cuda_topk_block` writes."""
    n, P = s.n_frames, s.H * s.W
    n_tiles = -(-P // TILE_PIXELS)
    padded = torch.full((n, n_tiles * TILE_PIXELS), KEY_LAST,
                        dtype=torch.int64, device=t_raw.device)
    padded[:, :P] = topk_keys_signed(t_raw)
    best = torch.sort(padded.reshape(n, n_tiles, TILE_PIXELS), dim=-1
                      ).values[..., :_tile_keep(s)]
    return flip_key_order(best)


def _merge(keys, img, s: Static):
    """Merge the tile key lists (unsigned 64-bit keys held in int64):
    ``(the k smallest in signed order, the mean of I over them)``."""
    x = _frames(img, s).reshape(s.n_frames, -1, 3)
    flat = flip_key_order(keys.reshape(s.n_frames, -1))
    best = torch.sort(flat, dim=-1).values[:, :s.topk]
    return best, topk_mean(x, key_index(best))


def plain_topk_merge(keys, img, s: Static):
    return _merge(keys, img, s)[1]


def plain_candidate(keys, img, s: Static):
    best, cand = _merge(keys, img, s)
    return key_t(best[:, 0]), cand.to(s.out_dtype)


def plain_ema(cand, ids, carry_f, carry_i, s: Static):
    A = carry_f.to(torch.float32)
    k = carry_i[:, 0].to(torch.int32)
    inited = carry_i[:, 1] != 0
    c = cand.reshape(s.L, s.B, 3).to(torch.float32)
    ids = ids.reshape(s.L, s.B).to(torch.int32)
    seq = []
    for b in range(s.B):
        A, k, inited = ref.ema_step(c[:, b], ids[:, b], A, k, inited,
                                    period=s.period, lam=s.lam)
        seq.append(A)
    ci = torch.stack([k, inited.to(torch.int32)], dim=-1)
    return torch.stack(seq, dim=1), A, ci


def plain_box_rows4(g, t_raw, s: Static):
    r = s.gf_radius
    return torch.stack([window_sum(v, r, -2)
                        for v in (g, t_raw, g * t_raw, g * g)])


def plain_box_cols_ab(rows4, s: Static):
    cnt = window_counts(s.H, s.W, s.gf_radius, rows4.device)
    mean_g, mean_p, corr_gp, corr_gg = (window_sum(v, s.gf_radius, -1) / cnt
                                        for v in rows4)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + s.gf_eps)
    return torch.stack([a, mean_p - a * mean_g])


def plain_box_rows2(ab, s: Static):
    return torch.stack([window_sum(v, s.gf_radius, -2) for v in ab])


def _refined_t(t_raw, g, rows2, s: Static):
    """clip(mean_a * g + mean_b, 0, 1) from the a/b row sums; t_raw
    without refine."""
    if not s.refine:
        return t_raw
    cnt = window_counts(s.H, s.W, s.gf_radius, t_raw.device)
    mean_a = window_sum(rows2[0], s.gf_radius, -1) / cnt
    mean_b = window_sum(rows2[1], s.gf_radius, -1) / cnt
    return torch.clamp(mean_a * g + mean_b, 0.0, 1.0)


def plain_recover(img, t_raw, g, rows2, a_seq, s: Static):
    x = _frames(img, s)
    t = _refined_t(t_raw, g, rows2, s)
    tt = torch.clamp_min(t, s.t0)[..., None]
    A = a_seq.reshape(s.n_frames, 3)[:, None, None, :]
    J = torch.clamp((x - A) / tt + A, 0.0, 1.0)
    if s.gamma != 1.0:
        J = J ** s.gamma
    shape = (s.L, s.B, s.H, s.W)
    return (J.reshape(shape + (3,)).to(s.out_dtype),
            t.reshape(shape).to(s.out_dtype))


def plain_tmap(t_raw, g, rows2, s: Static):
    return _refined_t(t_raw, g, rows2, s).reshape(
        s.L, s.B, s.H, s.W).to(s.out_dtype)


Passes = Dict[str, Callable]

CUDA_PASSES: Passes = {name: globals()[f"cuda_{name}"] for name in PASSES}
PLAIN_PASSES: Passes = {name: globals()[f"plain_{name}"] for name in PASSES}

#: The transmission stage's passes, every CUDA one counted in
#: :data:`transmission_launches`.
TRANSMISSION_CUDA_PASSES: Passes = {
    name: functools.partial(globals()[f"cuda_{name}"],
                            counts=transmission_launches)
    for name in TRANSMISSION_PASSES}
TRANSMISSION_PLAIN_PASSES: Passes = {
    name: globals()[f"plain_{name}"] for name in TRANSMISSION_PASSES}


def run_passes(img, frame_ids, carry_f, carry_i, s: Static,
               passes: Passes = CUDA_PASSES):
    """The megakernel's pass sequence, through ``passes``. Returns
    ``(J, t, a_seq, carry_f', carry_i')``."""
    pre, g = passes["premap"](img, carry_f, s)
    t_raw = passes["min_cols_tmap"](passes["min_rows"](pre, s), s)
    cand = passes["topk_merge"](passes["topk_block"](t_raw, s), img, s)
    a_seq, cf, ci = passes["ema"](cand, frame_ids, carry_f, carry_i, s)
    rows2 = None
    if s.refine:
        ab = passes["box_cols_ab"](passes["box_rows4"](g, t_raw, s), s)
        rows2 = passes["box_rows2"](ab, s)
    J, t = passes["recover"](img, t_raw, g, rows2, a_seq, s)
    return J, t, a_seq, cf, ci


def run_transmission_passes(img, a_saved, s: Static,
                            passes: Passes = TRANSMISSION_CUDA_PASSES):
    """The fused transmission stage's pass sequence, through ``passes``:
    (L, B, H, W, 3) frames and per-lane saved A (L, 3) -> ``(t (L, B, H, W)
    and cand (L, B, 3) in the output dtype, t_min (L, B) float32)``."""
    pre, g = passes["premap"](img, a_saved, s)
    t_raw = passes["min_cols_tmap"](passes["min_rows"](pre, s), s)
    t_min, cand = passes["candidate"](passes["topk_block"](t_raw, s), img, s)
    rows2 = None
    if s.refine:
        ab = passes["box_cols_ab"](passes["box_rows4"](g, t_raw, s), s)
        rows2 = passes["box_rows2"](ab, s)
    t = passes["tmap"](t_raw, g, rows2, s)
    return t, t_min.reshape(s.L, s.B), cand.reshape(s.L, s.B, 3)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def fused_dehaze_lanes(img: torch.Tensor, frame_ids: torch.Tensor,
                       carry_f: torch.Tensor, carry_i: torch.Tensor, *,
                       algorithm: str = "dcp", radius: int,
                       omega: float = 0.95, beta: float = 1.0,
                       cap_w: Sequence[float] = ref.CAP_COEFFS,
                       refine: bool, gf_radius: int, gf_eps: float,
                       t0: float, gamma: float, period: int, lam: float,
                       topk: int = 1, out_dtype: Optional[str] = None):
    """Lane-native dehaze of L streams: (L, B, H, W, 3) wire frames, (L, B)
    ids (< 0 = padding), carry rows ``carry_f (L, 3)`` f32 / ``carry_i
    (L, 2)`` int32 -> ``(J, t, a_seq (L, B, 3) f32, carry_f', carry_i')``
    with J/t in ``ref.resolve_out_dtype(img.dtype, out_dtype)``.

    CPU tensors run the plain version; CUDA tensors run the kernels (built
    at first use) or raise."""
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=cap_w, refine=refine, gf_radius=gf_radius, gf_eps=gf_eps,
              t0=t0, gamma=gamma, period=period, lam=lam, topk=topk,
              out_dtype=out_dtype)
    s = make_static(img, **kw)
    if frame_ids.shape != (s.L, s.B):
        raise ValueError(f"frame_ids {tuple(frame_ids.shape)} != (L, B) = "
                         f"{(s.L, s.B)}")
    if carry_f.shape != (s.L, 3) or carry_i.shape != (s.L, 2):
        raise ValueError("carry rows must be (L, 3) and (L, 2)")
    if img.device.type == "cpu":
        return ref.fused_dehaze_lanes(img, frame_ids, carry_f, carry_i, **kw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img)
    dev = img.device
    ids = frame_ids.to(device=dev, dtype=torch.int32).contiguous()
    cf = carry_f.to(device=dev, dtype=torch.float32).contiguous()
    ci = carry_i.to(device=dev, dtype=torch.int32).contiguous()
    return run_passes(img, ids, cf, ci, s)


def fused_dehaze(img: torch.Tensor, frame_ids: torch.Tensor,
                 A_saved: torch.Tensor, last_update: torch.Tensor,
                 initialized: torch.Tensor, **kw):
    """Single stream, the L=1 view of :func:`fused_dehaze_lanes`:
    (B, H, W, 3) -> ``(J, t, a_seq (B, 3), A_fin (3,), k_fin ())``."""
    dev = img.device
    carry_f = A_saved.to(device=dev, dtype=torch.float32).reshape(1, 3)
    carry_i = torch.stack([last_update.to(device=dev, dtype=torch.int32),
                           initialized.to(device=dev, dtype=torch.int32)]
                          ).reshape(1, 2)
    J, t, a_seq, cf, ci = fused_dehaze_lanes(
        img[None], frame_ids.reshape(1, -1), carry_f, carry_i, **kw)
    return J[0], t[0], a_seq[0], cf[0], ci[0, 0]


def fused_transmission_lanes(img: torch.Tensor, A_saved: torch.Tensor, *,
                             algorithm: str = "dcp", radius: int,
                             omega: float = 0.95, beta: float = 1.0,
                             cap_w: Sequence[float] = ref.CAP_COEFFS,
                             refine: bool, gf_radius: int, gf_eps: float,
                             topk: int = 1, out_dtype: Optional[str] = None):
    """The fused transmission stage of L lanes: (L, B, H, W, 3) wire frames
    and per-lane saved A (L, 3) -> ``(t (L, B, H, W), t_min (L, B) float32,
    cand (L, B, 3))``, t and cand in ``ref.resolve_out_dtype(img.dtype,
    out_dtype)``; frame row i of the flat L*B batch reads lane i // B's A.

    CPU tensors run the plain version; CUDA tensors run the kernels (built
    at first use) or raise."""
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=cap_w, refine=refine, gf_radius=gf_radius, gf_eps=gf_eps,
              topk=topk, out_dtype=out_dtype)
    # The EMA and recovery constants do not reach the stage's passes.
    s = make_static(img, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
    if tuple(A_saved.shape) != (s.L, 3):
        raise ValueError(f"A_saved {tuple(A_saved.shape)} != (L, 3) = "
                         f"{(s.L, 3)}")
    if img.device.type == "cpu":
        return ref.fused_transmission_lanes(img, A_saved, **kw)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img)
    a = A_saved.to(device=img.device, dtype=torch.float32).contiguous()
    return run_transmission_passes(img, a, s)


def fused_transmission(img: torch.Tensor, A_saved: torch.Tensor, **kw):
    """One stream, the L=1 view of :func:`fused_transmission_lanes`:
    (B, H, W, 3) frames, saved A (3,) -> ``(t (B, H, W), t_min (B,),
    cand (B, 3))``."""
    t, t_min, cand = fused_transmission_lanes(img[None], A_saved.reshape(1, 3),
                                              **kw)
    return t[0], t_min[0], cand[0]
