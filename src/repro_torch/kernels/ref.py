"""Plain PyTorch versions of the dehazing kernels (the port's oracles).

Each function is the PyTorch counterpart of the JAX package's function of
the same name in ``kernels/ref.py`` and follows its semantics to float32
round-off; ``tests/test_torch_ref.py`` holds them to it. They run on any
device. The CUDA megakernel (``kernels.fused``) is held against
:func:`fused_dehaze_lanes` on the card, and CPU callers of the port run
these directly.

Conventions: images are ``(..., H, W, C)`` float in [0, 1]; scalar maps
are ``(..., H, W)``. Arithmetic is written one PyTorch operation per
rounding step (no fused multiply-add), which is what lets the CUDA kernel
reproduce ``t_raw`` and the EMA bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Frame I/O dtype contract
# ---------------------------------------------------------------------------

U8_SCALE = 255.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "uint8": torch.uint8}

DTypeLike = Union[str, torch.dtype]


def as_torch_dtype(dt: DTypeLike) -> torch.dtype:
    """``"float32" | "bfloat16" | "uint8"`` (or a torch dtype) -> torch
    dtype. Anything else raises."""
    if isinstance(dt, torch.dtype):
        if dt not in _DTYPES.values():
            raise ValueError(f"unsupported frame dtype {dt}")
        return dt
    try:
        return _DTYPES[str(dt)]
    except KeyError:
        raise ValueError(f"unsupported frame dtype {dt!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def upcast_frames(x: torch.Tensor) -> torch.Tensor:
    """Wire dtype -> float32. uint8 is ``round(v * 255)`` of the [0, 1]
    image, so the upcast multiplies by ``float32(1/255)`` (it does not
    divide); bfloat16 widens exactly; float32 is the identity."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * (1.0 / U8_SCALE)
    return x.to(torch.float32)


def resolve_out_dtype(in_dtype: DTypeLike,
                      out_dtype: Optional[str] = None) -> torch.dtype:
    """J/t output dtype: ``None``/"auto" follows float ingest and resolves
    to float32 for uint8 ingest; otherwise the named dtype."""
    if out_dtype is not None and out_dtype != "auto":
        return as_torch_dtype(out_dtype)
    d = as_torch_dtype(in_dtype)
    return d if d.is_floating_point else torch.float32


def quantize_frames(x, io_dtype: DTypeLike) -> torch.Tensor:
    """Host-side [0, 1] float frames -> a CPU tensor in the wire dtype.

    uint8 is ``round(clip(v, 0, 1) * 255)`` (round half to even, as
    numpy); floats are a plain cast (bfloat16 rounds to nearest even)."""
    dt = as_torch_dtype(io_dtype)
    arr = np.asarray(x, np.float32)
    if dt == torch.uint8:
        q = np.clip(np.round(arr * np.float32(U8_SCALE)), 0.0, U8_SCALE)
        return torch.from_numpy(q.astype(np.uint8))
    return torch.from_numpy(arr.copy()).to(dt)


# ---------------------------------------------------------------------------
# Windowed min (dark channel prior, Eq. 3) and windowed mean
# ---------------------------------------------------------------------------

def _planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Size]:
    """(..., H, W) -> (N, 1, H, W) view for the pooling calls."""
    return x.reshape(-1, 1, x.shape[-2], x.shape[-1]), x.shape


def min_filter_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed minimum over a (2r+1)² box clipped at the borders (the
    window is its intersection with the image: +inf padding)."""
    if radius == 0:
        return x
    v, shape = _planes(x)
    out = -F.max_pool2d(-v, 2 * radius + 1, stride=1, padding=radius)
    return out.reshape(shape)


def dark_channel(img: torch.Tensor, radius: int) -> torch.Tensor:
    """min over channels, then windowed min. (..., H, W, 3) -> (..., H, W)."""
    return min_filter_2d(img.amin(-1), radius)


def box_filter_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed mean over the clipped (2r+1)² box, divided by the number
    of in-bounds window elements."""
    if radius == 0:
        return x
    v, shape = _planes(x.to(torch.float32))
    out = F.avg_pool2d(v, 2 * radius + 1, stride=1, padding=radius,
                       count_include_pad=False)
    return out.reshape(shape).to(x.dtype)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int,
                  eps: float) -> torch.Tensor:
    """Gray-guide guided filter (He et al.). guide/src: (..., H, W)."""
    g = guide.to(torch.float32)
    p = src.to(torch.float32)
    mean_g = box_filter_2d(g, radius)
    mean_p = box_filter_2d(p, radius)
    corr_gp = box_filter_2d(g * p, radius)
    corr_gg = box_filter_2d(g * g, radius)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + eps)
    b = mean_p - a * mean_g
    mean_a = box_filter_2d(a, radius)
    mean_b = box_filter_2d(b, radius)
    return (mean_a * g + mean_b).to(src.dtype)


# ---------------------------------------------------------------------------
# Atmospheric light (Eq. 5/6, robust top-k form) and recovery (Eq. 8)
# ---------------------------------------------------------------------------

def atmospheric_light(img: torch.Tensor, t_raw: torch.Tensor,
                      k: int = 1) -> torch.Tensor:
    """Mean of I over the k pixels with the smallest raw transmission.
    ``img`` (..., H, W, 3), ``t_raw`` (..., H, W) -> (..., 3)."""
    flat_t = t_raw.reshape(*t_raw.shape[:-2], -1)
    flat_i = img.reshape(*img.shape[:-3], -1, 3)
    # Ties to the lowest index, as lax.top_k of -t: a stable ascending sort.
    idx = torch.sort(flat_t, dim=-1, stable=True).indices[..., :k]
    picked = torch.gather(flat_i, -2, idx[..., None].expand(*idx.shape, 3))
    return picked.mean(-2)


def recover(hazy: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
            t0: float = 0.1) -> torch.Tensor:
    """J = clip((I - A)/max(t, t0) + A, 0, 1). A: (..., 3)."""
    tt = torch.clamp_min(t, t0)[..., None]
    A = A[..., None, None, :]
    return torch.clamp((hazy - A) / tt + A, 0.0, 1.0).to(hazy.dtype)


# ---------------------------------------------------------------------------
# Pre-maps (Eq. 3 inner min, CAP Eq. 4 depth) and the transmission map
# ---------------------------------------------------------------------------

# Published CAP linear-model coefficients (w0, w1, w2).
CAP_COEFFS = (0.121779, 0.959710, -0.780245)

# Rec.601 luma: the guided filter's guide.
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


def cap_depth(img: torch.Tensor, w0: float, w1: float,
              w2: float) -> torch.Tensor:
    """d(x) = w0 + w1 * value(x) + w2 * saturation(x) from RGB in [0, 1]."""
    v = img.amax(-1)
    mn = img.amin(-1)
    s = torch.where(v > 0, (v - mn) / torch.clamp_min(v, 1e-12),
                    torch.zeros_like(v))
    return (w0 + w1 * v + w2 * s).to(img.dtype)


def luminance(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma in float32, ``(0.299 r + 0.587 g) + 0.114 b``."""
    x = img.to(torch.float32)
    return (LUMA_WEIGHTS[0] * x[..., 0] + LUMA_WEIGHTS[1] * x[..., 1]
            + LUMA_WEIGHTS[2] * x[..., 2])


def premap(x: torch.Tensor, a0: torch.Tensor, algorithm: str,
           cap_w: Sequence[float] = CAP_COEFFS) -> torch.Tensor:
    """Per-pixel stage-1 map: DCP ``min_c I/A`` (Eq. 3) or CAP depth
    (Eq. 4). ``a0`` broadcasts against ``x`` (CAP ignores it)."""
    if algorithm == "dcp":
        return (x / a0).amin(-1)
    return cap_depth(x, *cap_w)


def tmap_from_dark(dark: torch.Tensor, algorithm: str, omega: float,
                   beta: float) -> torch.Tensor:
    """Min-filtered pre-map -> raw transmission: DCP ``1 - omega*dark``,
    CAP ``exp(-beta*dark)``."""
    if algorithm == "dcp":
        return 1.0 - omega * dark
    return torch.exp(-beta * dark)


def fused_transmission(img: torch.Tensor, A_saved: torch.Tensor, *,
                       algorithm: str = "dcp", radius: int,
                       omega: float = 0.95, beta: float = 1.0,
                       cap_w: Sequence[float] = CAP_COEFFS, refine: bool,
                       gf_radius: int, gf_eps: float, topk: int = 1,
                       out_dtype: Optional[str] = None):
    """(B, H, W, 3) wire frames + saved A (3,) -> (t, t_min (B,),
    cand_rgb (B, 3)): transmission, guided refinement and the per-frame
    atmospheric-light candidate (argmin-t pixel for ``topk == 1``, the mean
    of the ``topk`` smallest-t pixels otherwise)."""
    odt = resolve_out_dtype(img.dtype, out_dtype)
    b = img.shape[0]
    x = upcast_frames(img)
    a0 = torch.clamp_min(A_saved.to(torch.float32), 1e-3)
    pre = premap(x, a0, algorithm, cap_w)
    dark = min_filter_2d(pre, radius)
    t_raw = tmap_from_dark(dark, algorithm, omega, beta)
    flat_t = t_raw.reshape(b, -1)
    j = flat_t.argmin(-1)                  # first index of the minimum
    t_min = flat_t.gather(-1, j[:, None])[:, 0]
    if topk == 1:
        cand = x.reshape(b, -1, 3)[torch.arange(b, device=x.device), j]
    else:
        cand = atmospheric_light(x, t_raw, topk)
    if refine:
        t = torch.clamp(guided_filter(luminance(x), t_raw, gf_radius, gf_eps),
                        0.0, 1.0)
    else:
        t = t_raw
    return t.to(odt), t_min, cand.to(odt)


def fused_transmission_dcp(*args, **kw):
    """Back-compat entry point (the reference's first, DCP-only name) ->
    :func:`fused_transmission` with ``algorithm="dcp"``."""
    return fused_transmission(*args, algorithm="dcp", **kw)


def fused_transmission_lanes(img: torch.Tensor, A_saved: torch.Tensor,
                             **kw):
    """Lane form of :func:`fused_transmission`: (L, B, H, W, 3) frames and
    per-lane saved A (L, 3) -> ``(t (L, B, H, W), t_min (L, B), cand_rgb
    (L, B, 3))``, each lane on its own."""
    outs = [fused_transmission(img[lane], A_saved[lane], **kw)
            for lane in range(img.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# The spatially sharded step: one shard's transmission stage on its
# halo-extended planes, and the cross-shard candidate merge
# ---------------------------------------------------------------------------

def topk_positions(flat_t: torch.Tensor, key2: torch.Tensor,
                k: int) -> torch.Tensor:
    """(N, M) t and a second int key -> (N, k) positions of the k smallest
    (t, key2), ties in both to the lower position: a stable two-key sort
    (-0.0 ties with +0.0, as ``lax.sort`` canonicalises it)."""
    flat_t = torch.where(flat_t == 0, torch.zeros_like(flat_t), flat_t)
    by_key2 = torch.sort(key2, dim=-1, stable=True).indices
    t2 = torch.gather(flat_t, -1, by_key2)
    by_t = torch.sort(t2, dim=-1, stable=True).indices
    return torch.gather(by_key2, -1, by_t)[:, :k]


def topk_candidates(t_raw: torch.Tensor, x: torch.Tensor, k: int):
    """(N, h, w) t and (N, h, w, 3) pixels -> the k smallest (t, flat
    index) of each frame, ascending (ties to the lowest index, as
    ``lax.top_k`` of -t): ``(tk_t (N, k) float32, tk_rgb (N, k, 3)
    float32, tk_idx (N, k) int32)``."""
    n = t_raw.shape[0]
    flat_t = t_raw.reshape(n, -1).to(torch.float32)
    idx = torch.sort(flat_t, dim=-1, stable=True).indices[:, :k]
    tk_rgb = torch.gather(x.to(torch.float32).reshape(n, -1, 3), 1,
                          idx[..., None].expand(n, k, 3))
    return torch.gather(flat_t, -1, idx), tk_rgb, idx.to(torch.int32)


def fused_transmission_halo(img: torch.Tensor, pre_ext: torch.Tensor,
                            guide_ext: torch.Tensor, valid: torch.Tensor,
                            valid_w: Optional[torch.Tensor] = None, *,
                            algorithm: str = "dcp", radius: int,
                            omega: float = 0.95, beta: float = 1.0,
                            refine: bool, gf_radius: int, gf_eps: float,
                            topk: int = 1, out_dtype: Optional[str] = None):
    """One shard's transmission stage on its halo-extended planes.

    ``img`` (B, h, w, 3) is the shard's core block in any wire dtype;
    ``pre_ext``/``guide_ext`` (B, h + 2*halo_h, w + 2*halo_w) the exchanged
    pre-map and luma planes (float32 or bfloat16); ``valid`` the (h_ext,)
    row validity and ``valid_w`` the (w_ext,) column validity (None: every
    column valid, no width sharding). The masked min filter of
    ``core.spatial``, ``tmap_from_dark``, the masked guided filter, the
    core slice, the clip. Returns ``(t (B, h, w), tk_t (B, k) float32,
    tk_rgb (B, k, 3), tk_idx (B, k) int32)``: the k smallest (t_raw, local
    flat index) of the core, ascending, the index in the core's row stride
    w; t and tk_rgb in :func:`resolve_out_dtype`."""
    from repro_torch.core import spatial          # spatial imports this module
    odt = resolve_out_dtype(img.dtype, out_dtype)
    b, h_loc, w_loc = img.shape[0], img.shape[1], img.shape[2]
    halo_h = (pre_ext.shape[1] - h_loc) // 2
    halo_w = (pre_ext.shape[2] - w_loc) // 2
    dark = spatial.masked_min_filter_2d(pre_ext.to(torch.float32), valid,
                                        radius, valid_w)
    t_raw_ext = tmap_from_dark(dark, algorithm, omega, beta)
    core = (slice(None), slice(halo_h, halo_h + h_loc),
            slice(halo_w, halo_w + w_loc))
    t_raw = t_raw_ext[core]
    if refine:
        t_ext = spatial.masked_guided_filter(guide_ext.to(torch.float32),
                                             t_raw_ext, valid, gf_radius,
                                             gf_eps, valid_w)
        t = torch.clamp(t_ext[core], 0.0, 1.0)
    else:
        t = t_raw
    tk_t, tk_rgb, idx = topk_candidates(t_raw, upcast_frames(img), topk)
    return t.to(odt), tk_t, tk_rgb.to(odt), idx


def merge_topk_candidates(tk_t: torch.Tensor, tk_idx: torch.Tensor,
                          tk_rgb: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M) t and global flat indices, (B, M, 3) rgb -> (B, 3) float32:
    the mean rgb of the k smallest (t, index) rows (a stable two-key sort,
    as the reference's ``lax.sort`` with two keys), in any order of the
    rows."""
    rgb = tk_rgb.to(torch.float32)
    pick = topk_positions(tk_t.to(torch.float32), tk_idx.to(torch.int64), k)
    top = torch.gather(rgb, 1, pick[..., None].expand(-1, -1, 3))
    return top.mean(1)


# ---------------------------------------------------------------------------
# The Eq. 9 EMA step and the megakernel's plain version
# ---------------------------------------------------------------------------

def ema_step(cand: torch.Tensor, fid: torch.Tensor, A_prev: torch.Tensor,
             k_prev: torch.Tensor, inited: torch.Tensor, *, period: int,
             lam: float):
    """One step of the paper's Eq. 9 update, batched over leading axes.

    ``cand``/``A_prev`` (..., 3) float32; ``fid``/``k_prev`` (...) int32
    (int32 arithmetic wraps as on the reference); ``inited`` (...) bool.
    A padding frame (``fid < 0``) changes nothing. Returns
    ``(A, k, inited)``."""
    valid = fid >= 0
    bootstrap = valid & ~inited
    do = valid & (bootstrap | ((fid - k_prev) >= period))
    target = torch.where(bootstrap[..., None], cand,
                         lam * cand + (1.0 - lam) * A_prev)
    A = torch.where(do[..., None], target, A_prev)
    k = torch.where(do, fid, k_prev)
    return A, k, inited | valid


def fused_dehaze(img: torch.Tensor, frame_ids: torch.Tensor,
                 A_saved: torch.Tensor, last_update: torch.Tensor,
                 initialized: torch.Tensor, *, algorithm: str = "dcp",
                 radius: int, omega: float = 0.95, beta: float = 1.0,
                 cap_w: Sequence[float] = CAP_COEFFS, refine: bool,
                 gf_radius: int, gf_eps: float, t0: float, gamma: float,
                 period: int, lam: float, topk: int = 1,
                 out_dtype: Optional[str] = None,
                 out: Optional[torch.Tensor] = None):
    """Plain version of the single-stream megakernel: (B, H, W, 3) ->
    ``(J, t, a_seq (B, 3) f32, A_fin (3,), k_fin ())``.

    The pre-map of every frame uses the batch-entry saved A (§3.3);
    recovery uses the per-frame EMA output. J/t are cast to
    :func:`resolve_out_dtype`; J is copied into ``out`` where given (which
    may be ``img`` itself: nothing reads the frames after J)."""
    odt = resolve_out_dtype(img.dtype, out_dtype)
    x = upcast_frames(img)
    t, _, cand = fused_transmission(
        x, A_saved, algorithm=algorithm, radius=radius, omega=omega,
        beta=beta, cap_w=cap_w, refine=refine, gf_radius=gf_radius,
        gf_eps=gf_eps, topk=topk)
    ids = frame_ids.to(device=x.device, dtype=torch.int32)
    A = A_saved.to(device=x.device, dtype=torch.float32)
    k = last_update.to(device=x.device, dtype=torch.int32)
    inited = initialized.to(device=x.device, dtype=torch.bool)
    seq = []
    for i in range(x.shape[0]):
        A, k, inited = ema_step(cand[i].to(torch.float32), ids[i], A, k,
                                inited, period=period, lam=lam)
        seq.append(A)
    a_seq = torch.stack(seq) if seq else A.new_zeros((0, 3))
    tt = torch.clamp_min(t.to(torch.float32), t0)[..., None]
    A_b = a_seq[:, None, None, :]
    J = torch.clamp((x - A_b) / tt + A_b, 0.0, 1.0)
    if gamma != 1.0:
        J = J ** gamma
    J = J.to(odt) if out is None else out.copy_(J)
    return J, t.to(odt), a_seq, A, k


def fused_dehaze_dcp(*args, **kw):
    """Back-compat entry point (the reference's first, DCP-only name) ->
    :func:`fused_dehaze` with ``algorithm="dcp"``."""
    return fused_dehaze(*args, algorithm="dcp", **kw)


def fused_dehaze_lanes(img: torch.Tensor, frame_ids: torch.Tensor,
                       carry_f: torch.Tensor, carry_i: torch.Tensor,
                       out: Optional[torch.Tensor] = None, **kw):
    """Lane form of :func:`fused_dehaze`: (L, B, H, W, 3) frames, (L, B)
    ids, carry rows ``carry_f (L, 3)`` f32 / ``carry_i (L, 2)`` int32
    (last_update, initialized) -> ``(J, t, a_seq (L, B, 3), carry_f',
    carry_i')``. Each lane runs on its own; an all-padding lane's carry
    passes through unchanged."""
    outs = []
    for lane in range(img.shape[0]):
        ci = carry_i[lane].to(torch.int32)
        j, t, a_seq, a_fin, k_fin = fused_dehaze(
            img[lane], frame_ids[lane], carry_f[lane], ci[0],
            ci[1] != 0, out=None if out is None else out[lane], **kw)
        ids = frame_ids[lane].to(ci.device)
        inited = torch.maximum(ci[1], (ids >= 0).any().to(torch.int32))
        outs.append((j, t, a_seq, a_fin, torch.stack([k_fin, inited])))
    res = tuple(torch.stack(o) for o in zip(*outs))
    return res if out is None else (out,) + res[1:]
