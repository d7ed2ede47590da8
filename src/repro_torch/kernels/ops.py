"""Dispatch wrappers for the dehazing kernels (PyTorch port).

``mode`` selects how an op runs:

  - ``"ref"``    : the plain PyTorch chain (``kernels.ref``), any device;
  - ``"pallas"`` : the staged chain, each component a hand-written CUDA
                   kernel (``kernels.staged``) on CUDA tensors and its plain
                   version on CPU tensors;
  - ``"auto"``   : ``REPRO_KERNEL_MODE`` where it names a substrate (ref |
                   pallas | interpret), else ``"pallas"``, as the reference
                   resolves it on an accelerator;
  - ``"fused"``  : the whole chain as the hand-written CUDA megakernel
                   (``kernels.fused``); the staged ops of a config the
                   megakernel does not cover (DCP with
                   ``recompute_t_with_final_a``) run as under ``"pallas"``;
  - ``"interpret"``: a Pallas-on-CPU substrate with no counterpart here:
                   raises ``ValueError``.

``REPRO_KERNEL_MODE=ref`` also sends ``"fused"`` to the plain chain, as on
the reference. Every staged op of the reference has its kernel: the dark
channel, the windowed min of staged CAP, the box filter, the argmin and
the top-k (``k > 1``) atmospheric light, and recovery. The fused
transmission stage of the data-parallel sharded step
(:func:`fused_transmission`, :func:`fused_transmission_lanes`) and its
halo form for a spatial shard (:func:`fused_transmission_halo`) run the
megakernel's passes under any mode but ``"ref"``. The masked filters
(:func:`masked_min_filter_2d`, :func:`masked_box_filter_2d` and the
:func:`masked_guided_filter` over it) and the cross-shard merge
(:func:`merge_topk_candidates`) run their kernels of ``kernels.staged``
under any mode but ``"ref"`` (``core.spatial``'s plain filters there):
the staged branch of the sharded steps (frame-sharded, lane-sharded
without the lane-native megakernel, and spatial, under ``"auto"``,
``"pallas"`` and the ``"fused"`` configs the megakernel does not cover)
calls the masked filters once a step (a tile) for the min and six times
for the guided filter's means. Every step but the lane-native
megakernel's ends in :func:`merge_ema`, the candidate rows' merge and the
§3.3 EMA as one kernel under any mode but ``"ref"``: once a step (a tick
of the staged serve); the spatial steps no longer call the merge alone.

The kernels' own tuning knobs (``kernels.tuning``) are keyword arguments
of :func:`fused_dehaze` (``tile``, ``blocks_per_sm``; op ``fused_<alg>``
or ``fused_<alg>_topk`` at (B, H, W)), :func:`fused_dehaze_lanes` (and
``grid_order``; ``fused_lanes`` at (L, B, H, W)),
:func:`fused_transmission_halo` (``fused_halo_2d`` at (N, h, w)) and
:func:`atmospheric_light` (``tile_pixels``; ``atmolight`` or
``atmolight_topk`` at (N, H, W)). ``None``, the default, resolves a knob
with ``tuning.resolve`` (env override, the card's table entry, the
default), once per op, bucket, dtype and device kind while the table
holds; under every mode but ``"ref"`` and on any device, so a bad table
entry or override raises ``ValueError`` wherever it would be used, and a
variant that fails to build raises too. A caller that passes ``tuned``,
a dict of its own (each step of ``core.pipeline`` keeps one), resolves a
shape once and then reads the knobs from it. Nothing falls back to a default.
The fused transmission stage (B7) stays on the default knobs, as the
reference does not tune it. The TPU's knobs (``frames_per_block``,
``buffer_depth``) have no counterpart: the back-compat aliases
(:func:`fused_dehaze_dcp`, :func:`fused_transmission_dcp`) take
``frames_per_block`` at its default of 0 only.

:func:`launch_count` counts the hand-written kernel launches of one call
from the wrappers' per-kernel counters, the counterpart of the reference's
``pallas_launch_count``. The reference's ``dma_copy_count`` has none: the
CUDA kernels' copies are ``cp.async`` inside a kernel, not operations of a
traced program.
"""
from __future__ import annotations

from typing import Callable, Dict, Literal, Optional, Sequence, Tuple

import torch

from repro_torch.core import env as _env
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import staged as _staged
from repro_torch.kernels.ref import CAP_COEFFS

Mode = Literal["auto", "ref", "pallas", "interpret", "fused"]

MODES = _env.KERNEL_MODES


def resolve_mode(mode: Mode = "auto") -> str:
    """Resolve to ``"ref"``, ``"pallas"`` or ``"fused"`` (see the module
    docstring). ``"interpret"``, and unknown values in the argument or in
    ``REPRO_KERNEL_MODE``, raise ``ValueError``."""
    if mode not in MODES:
        raise ValueError(
            f"unknown kernel mode {mode!r}; expected one of {sorted(MODES)}")
    env = _env.kernel_mode()
    m = mode
    if m == "auto":
        m = env if env in _env.SUBSTRATES else "pallas"
    if m == "fused" and env == "ref":
        m = "ref"
    if m == "interpret":
        raise ValueError("kernel_mode 'interpret' runs Pallas kernel bodies "
                         "on the CPU and has no counterpart in repro_torch")
    return m


def _knobs(op: str, shape, dtype, device, tuned: Optional[dict] = None,
           **given) -> Dict[str, object]:
    """The knobs ``given`` of ``op``, each ``None`` resolved: from
    ``tuned`` (a dict that a caller keeps across its calls, keyed by op,
    shape, dtype and device) where it holds them, else with
    ``tuning.resolve``, whose answer ``tuned`` then keeps. Values given
    are checked (``tuning.check_params``); resolved ones were checked when
    they were resolved. The dict returned may be shared: do not modify
    it."""
    explicit = {k: v for k, v in given.items() if v is not None}
    key = (op, shape, dtype, device)
    params = tuned.get(key) if tuned is not None and not explicit else None
    if params is not None:
        return params
    # Imported here: ``python -m repro_torch.kernels.tuning`` runs the
    # module as ``__main__``, which an import at load would shadow.
    from repro_torch.kernels import tuning as _tuning
    if explicit:
        _tuning.check_params(op, explicit)
        if len(explicit) == len(given):
            return explicit
    params = _tuning.resolve(op, shape, dtype, device)
    if tuned is not None:
        tuned[key] = params
    return {**params, **explicit} if explicit else params


def _batched(x: torch.Tensor, rank: int):
    """Collapse leading dims so the ops always see (B, ...)."""
    lead = tuple(x.shape[: x.dim() - rank])
    return x.reshape((-1,) + tuple(x.shape[x.dim() - rank:])), lead


def dark_channel(img, radius: int, mode: Mode = "auto"):
    """(..., H, W, 3) -> (..., H, W)."""
    if resolve_mode(mode) == "ref":
        return _ref.dark_channel(img, radius)
    flat, lead = _batched(img, 3)
    return _staged.dark_channel_op(flat, radius).reshape(lead + flat.shape[1:3])


def min_filter_2d(x, radius: int, mode: Mode = "auto"):
    """(..., H, W) -> (..., H, W)."""
    if resolve_mode(mode) == "ref":
        return _ref.min_filter_2d(x, radius)
    flat, _ = _batched(x, 2)
    return _staged.min_filter_op(flat, radius).reshape(x.shape)


def box_filter_2d(x, radius: int, mode: Mode = "auto"):
    """(..., H, W) -> (..., H, W) windowed mean over the clipped box."""
    if resolve_mode(mode) == "ref":
        return _ref.box_filter_2d(x, radius)
    flat, lead = _batched(x, 2)
    return _staged.box_filter_op(flat, radius).reshape(x.shape)


def masked_min_filter_2d(x, valid, radius: int, valid_w=None,
                         mode: Mode = "auto"):
    """(..., H, W) with (H,) row validity and optional (W,) column validity
    -> the windowed min with invalid pixels +inf (the halo-extended plane
    of a spatial shard)."""
    if resolve_mode(mode) == "ref":
        from repro_torch.core import spatial
        return spatial.masked_min_filter_2d(x, valid, radius, valid_w)
    flat, _ = _batched(x, 2)
    return _staged.masked_min_filter_op(flat, valid, radius,
                                        valid_w).reshape(x.shape)


def masked_box_filter_2d(x, valid, radius: int, valid_w=None,
                         mode: Mode = "auto"):
    """(..., H, W) with row [and column] validity -> the windowed mean over
    the valid pixels only."""
    if resolve_mode(mode) == "ref":
        from repro_torch.core import spatial
        return spatial.masked_box_filter_2d(x, valid, radius, valid_w)
    flat, _ = _batched(x, 2)
    return _staged.masked_box_filter_op(flat, valid, radius,
                                        valid_w).reshape(x.shape)


def _guided(guide, src, eps: float, bf):
    """The gray-guide guided filter's algebra over the mean ``bf``: six
    means and the pointwise ops between them, in float32, cast back to
    ``src``'s dtype."""
    g = guide.to(torch.float32)
    p = src.to(torch.float32)
    mean_g = bf(g)
    mean_p = bf(p)
    corr_gp = bf(g * p)
    corr_gg = bf(g * g)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + eps)
    b = mean_p - a * mean_g
    return (bf(a) * g + bf(b)).to(src.dtype)


def guided_filter(guide, src, radius: int, eps: float, mode: Mode = "auto"):
    """Gray-guide guided filter: six box filters and pointwise algebra."""
    if resolve_mode(mode) == "ref":
        return _ref.guided_filter(guide, src, radius, eps)
    return _guided(guide, src, eps, lambda v: box_filter_2d(v, radius, mode))


def masked_guided_filter(guide, src, valid, radius: int, eps: float,
                         valid_w=None, mode: Mode = "auto"):
    """:func:`guided_filter` on a halo-extended plane, its six means over
    the valid rows [and columns] only (:func:`masked_box_filter_2d`); under
    ``"ref"`` ``core.spatial.masked_guided_filter``."""
    if resolve_mode(mode) == "ref":
        from repro_torch.core import spatial
        return spatial.masked_guided_filter(guide, src, valid, radius, eps,
                                            valid_w)
    # The masks as the kernels' bytes once, not once a mean.
    h, w = src.shape[-2:]
    valid = _staged.validity_bytes(valid, h, src.device)
    valid_w = None if valid_w is None else _staged.validity_bytes(
        valid_w, w, src.device)
    return _guided(guide, src, eps, lambda v: masked_box_filter_2d(
        v, valid, radius, valid_w, mode))


def atmospheric_light(img, t_raw, k: int = 1, mode: Mode = "auto",
                      tile_pixels: Optional[int] = None,
                      tuned: Optional[dict] = None):
    """(..., H, W, 3), (..., H, W) -> (..., 3): I at the argmin of t
    (``k == 1``), or the mean of I over the k smallest t. ``tile_pixels``
    is the kernels' tile (None: op ``atmolight`` or ``atmolight_topk`` of
    the tuning table at the flat (N, H, W); ``tuned`` as in
    :func:`fused_dehaze`)."""
    if resolve_mode(mode) == "ref":
        return _ref.atmospheric_light(img, t_raw, k)
    flat_i, lead = _batched(img, 3)
    flat_t, _ = _batched(t_raw, 2)
    op = "atmolight_topk" if k > 1 else "atmolight"
    tile = _knobs(op, flat_t.shape, None, img.device, tuned,
                  tile_pixels=tile_pixels)["tile_pixels"]
    out = (_staged.atmolight_topk_op(flat_i, flat_t, k, tile) if k > 1
           else _staged.atmolight_op(flat_i, flat_t, tile))
    return out.reshape(lead + (3,))


def merge_topk_candidates(tk_t, tk_idx, tk_rgb, k: int,
                          mode: Mode = "auto"):
    """(B, M) t and global flat indices, (B, M, 3) rgb -> (B, 3) float32:
    the mean rgb of the k smallest (t, index) rows, the spatial step's
    cross-shard candidate merge (M = shards x k after the all-gather)."""
    tk_t = tk_t.to(torch.float32).contiguous()
    tk_rgb = tk_rgb.to(torch.float32).contiguous()
    if resolve_mode(mode) == "ref":
        return _ref.merge_topk_candidates(tk_t, tk_idx, tk_rgb, k)
    return _staged.merge_topk_op(tk_t, tk_idx.to(torch.int32).contiguous(),
                                 tk_rgb, k)


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` contiguous in ``dtype``, with no call where it already is (the
    state sync runs once a tick on the host's critical path)."""
    if x.dtype != dtype:
        x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def merge_ema(tk_t, tk_idx, tk_rgb, k: int, frame_ids, state, period: int,
              lam: float, associative: bool = True, mode: Mode = "auto",
              out_state=None):
    """The §3.3 state sync that ends a step: per lane, each frame's
    candidate from its M rows (the mean rgb of the k smallest (t, global
    index) rows, as :func:`merge_topk_candidates`; the row itself at
    M = 1), then the lane's EMA over its B frames
    (``core.normalize.ema_scan_associative`` where ``associative``, else
    ``ema_scan``). (L, B, M) t and global indices (None at M = 1), (L, B,
    M, 3) rgb, (L, B) ids, a lane-batched ``AtmoState`` -> ``(a_seq (L, B,
    3) float32, new state)``. Where ``out_state`` is given (a donated
    state; it may be ``state`` itself) the new state goes into its tensors
    and the state returned holds them. Under ``"ref"`` the plain chain's
    merge (``kernels.ref``) and the scan; otherwise ``kernels.staged``'s
    merge-and-EMA kernel on CUDA tensors and its plain version (the same
    composition through the staged merge's plain version) on CPU ones."""
    from repro_torch.core.normalize import (AtmoState, ema_scan,
                                            ema_scan_associative)
    rgb = _as(tk_rgb, torch.float32)
    l, b, m = rgb.shape[:3]
    fields = (_as(state.A, torch.float32), _as(state.last_update, torch.int32),
              _as(state.initialized, torch.bool))
    ids = _as(frame_ids, torch.int32)
    if ids.device != rgb.device:
        ids = ids.to(rgb.device)
    out = None if out_state is None else (
        out_state.A, out_state.last_update, out_state.initialized)
    direct = out is not None and all(
        v.is_contiguous() and v.dtype == f.dtype and v.shape == f.shape
        for v, f in zip(out, fields))
    if b == 0:                      # an empty batch passes the state through
        a_seq, new = rgb.new_empty((l, 0, 3)), fields
    elif resolve_mode(mode) == "ref":
        cand = rgb[:, :, 0] if m == 1 else _ref.merge_topk_candidates(
            tk_t.reshape(l * b, m), tk_idx.reshape(l * b, m),
            rgb.reshape(l * b, m, 3), k).reshape(l, b, 3)
        scan = ema_scan_associative if associative else ema_scan
        a_seq, st = scan(cand, ids, AtmoState(*fields), period, lam)
        new = (st.A, st.last_update, st.initialized)
    else:
        lists = (None, None) if tk_t is None else (
            _as(tk_t, torch.float32), _as(tk_idx, torch.int32))
        a_seq, *new = _staged.merge_ema_op(
            *lists, rgb, k, ids, *fields, period, lam, associative,
            out if direct else None)
    if out is not None:
        for dst, src in zip(out, new):
            if dst is not src:
                dst.copy_(src)
        new = out
    return a_seq, AtmoState(*new)


def per_frame(A: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """Broadcast an atmospheric light to one row per frame: ``A`` of shape
    ``P + (3,)``, where ``P`` is a prefix of the frames' lead shape (``()``
    shared, ``(L,)`` per lane, ``lead`` per frame) -> ``lead + (3,)``."""
    p = A.dim() - 1
    if tuple(A.shape[:p]) != tuple(lead[:p]):
        raise ValueError(f"A {tuple(A.shape)} does not broadcast over frames "
                         f"with leading shape {lead}")
    return A.reshape(A.shape[:p] + (1,) * (len(lead) - p) + (3,)).expand(
        lead + (3,))


def recover(img, t, A, t0: float = 0.1, gamma: float = 1.0,
            mode: Mode = "auto", out=None):
    """(..., H, W, 3), (..., H, W), A per frame, lane or stream -> J in the
    frames' dtype, into ``out`` where given (which may be ``img``)."""
    lead = tuple(img.shape[:-3])
    A = per_frame(A, lead)
    if resolve_mode(mode) == "ref":
        J = _ref.recover(img, t, A, t0)
        J = J ** gamma if gamma != 1.0 else J
        return J if out is None else out.copy_(J)
    flat_i, _ = _batched(img, 3)
    flat_t, _ = _batched(t, 2)
    kw = {} if out is None else {"out": out.view(flat_i.shape)}
    J = _staged.recover_op(flat_i, flat_t, A.reshape(-1, 3).contiguous(), t0,
                           gamma, **kw)
    return J.reshape(img.shape)


def cap_depth(img, w0: float, w1: float, w2: float):
    """CAP linear depth model: elementwise, no kernel of its own."""
    return _ref.cap_depth(img, w0, w1, w2)


# ---------------------------------------------------------------------------
# The fused megakernel
# ---------------------------------------------------------------------------

def fused_dehaze(img: torch.Tensor, frame_ids: torch.Tensor,
                 A_saved: torch.Tensor, last_update: torch.Tensor,
                 initialized: torch.Tensor, *, algorithm: str = "dcp",
                 radius: int, omega: float = 0.95, beta: float = 1.0,
                 cap_w: Sequence[float] = CAP_COEFFS, refine: bool,
                 gf_radius: int, gf_eps: float, t0: float, gamma: float,
                 period: int, lam: float, topk: int = 1,
                 out_dtype: Optional[str] = "auto",
                 mode: Mode = "auto",
                 out: Optional[torch.Tensor] = None,
                 tile: Optional[str] = None,
                 blocks_per_sm: Optional[int] = None,
                 tuned: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """Whole DCP/CAP chain: (..., H, W, 3) -> (J, t, a_seq, A, k); J into
    ``out`` where given (which may be ``img`` where the dtypes agree).
    ``tile`` and ``blocks_per_sm`` are the tiled passes' knobs (None: op
    ``fused_<algorithm>``, ``_topk`` at k > 1, of the tuning table at the
    flat (B, H, W) and wire dtype). ``tuned``, a dict the caller keeps
    across calls (a step keeps one), holds the knobs resolved at each
    shape: a later call there resolves nothing."""
    m = resolve_mode(mode)
    flat, lead = _batched(img, 3)
    flat_ids = frame_ids.reshape(-1)
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=tuple(cap_w), refine=refine, gf_radius=gf_radius,
              gf_eps=gf_eps, t0=t0, gamma=gamma, period=period, lam=lam,
              topk=topk, out_dtype=out_dtype,
              out=None if out is None else out.view(flat.shape))
    fn = _ref.fused_dehaze
    if m != "ref":
        fn = _fused.fused_dehaze
        kw.update(_knobs(f"fused_{algorithm}" + ("_topk" if topk > 1 else ""),
                         flat.shape[:3], flat.dtype, img.device, tuned,
                         tile=tile, blocks_per_sm=blocks_per_sm))
    j, t, a_seq, a_fin, k_fin = fn(flat, flat_ids, A_saved, last_update,
                                   initialized, **kw)
    return (j.reshape(lead + tuple(j.shape[1:])),
            t.reshape(lead + tuple(t.shape[1:])),
            a_seq.reshape(lead + (3,)), a_fin, k_fin)


def fused_dehaze_lanes(img: torch.Tensor, frame_ids: torch.Tensor,
                       carry_f: torch.Tensor, carry_i: torch.Tensor, *,
                       algorithm: str = "dcp", radius: int,
                       omega: float = 0.95, beta: float = 1.0,
                       cap_w: Sequence[float] = CAP_COEFFS, refine: bool,
                       gf_radius: int, gf_eps: float, t0: float,
                       gamma: float, period: int, lam: float, topk: int = 1,
                       out_dtype: Optional[str] = "auto",
                       mode: Mode = "auto",
                       out: Optional[torch.Tensor] = None,
                       tile: Optional[str] = None,
                       blocks_per_sm: Optional[int] = None,
                       grid_order: Optional[str] = None,
                       tuned: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Lane-native fused dehaze: (L, B, H, W, 3), (L, B) ids and the
    (L, 3)/(L, 2) carry rows -> ``(J, t, a_seq (L, B, 3), carry_f',
    carry_i')``; per lane identical to :func:`fused_dehaze` on that lane,
    padding lanes (all ids < 0) untouched. J goes into ``out`` where given
    (which may be ``img`` where the dtypes agree). ``tile``,
    ``blocks_per_sm`` and ``grid_order`` are the tiled passes' knobs (None:
    op ``fused_lanes`` of the tuning table at (L, B, H, W) and the wire
    dtype; ``tuned`` as in :func:`fused_dehaze`)."""
    if img.dim() != 5:
        raise ValueError(f"expected (L, B, H, W, 3) frames, got {tuple(img.shape)}")
    m = resolve_mode(mode)
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=tuple(cap_w), refine=refine, gf_radius=gf_radius,
              gf_eps=gf_eps, t0=t0, gamma=gamma, period=period, lam=lam,
              topk=topk, out_dtype=out_dtype, out=out)
    fn = _ref.fused_dehaze_lanes
    if m != "ref":
        fn = _fused.fused_dehaze_lanes
        knobs = _knobs("fused_lanes", img.shape[:4], img.dtype, img.device,
                       tuned, tile=tile, blocks_per_sm=blocks_per_sm,
                       grid_order=grid_order)
        kw.update(tile=knobs["tile"], blocks_per_sm=knobs["blocks_per_sm"],
                  lane_major=knobs["grid_order"] == "lane_major")
    return fn(img, frame_ids, carry_f, carry_i, **kw)


def fused_transmission(img: torch.Tensor, A_saved: torch.Tensor, *,
                       algorithm: str = "dcp", radius: int,
                       omega: float = 0.95, beta: float = 1.0,
                       cap_w: Sequence[float] = CAP_COEFFS, refine: bool,
                       gf_radius: int, gf_eps: float, topk: int = 1,
                       out_dtype: Optional[str] = "auto",
                       mode: Mode = "auto") -> Tuple[torch.Tensor, ...]:
    """Fused t-map + A candidates (the data-parallel sharded step's stage):
    (..., H, W, 3) + saved A (3,) -> (t, t_min (...,), cand_rgb (..., 3)).
    The candidate is the argmin-t pixel for ``topk == 1``, the mean of the
    ``topk`` smallest-t pixels otherwise; t and the candidate are cast to
    the resolved output dtype, t_min is float32."""
    flat, lead = _batched(img, 3)
    fn = (_ref.fused_transmission if resolve_mode(mode) == "ref"
          else _fused.fused_transmission)
    t, t_min, cand = fn(flat, A_saved, algorithm=algorithm, radius=radius,
                        omega=omega, beta=beta, cap_w=tuple(cap_w),
                        refine=refine, gf_radius=gf_radius, gf_eps=gf_eps,
                        topk=topk, out_dtype=out_dtype)
    return (t.reshape(lead + tuple(t.shape[1:])), t_min.reshape(lead),
            cand.reshape(lead + (3,)))


def fused_transmission_lanes(img: torch.Tensor, A_saved: torch.Tensor, *,
                             algorithm: str = "dcp", radius: int,
                             omega: float = 0.95, beta: float = 1.0,
                             cap_w: Sequence[float] = CAP_COEFFS,
                             refine: bool, gf_radius: int, gf_eps: float,
                             topk: int = 1, out_dtype: Optional[str] = "auto",
                             mode: Mode = "auto") -> Tuple[torch.Tensor, ...]:
    """Lane form of :func:`fused_transmission`: (L, B, H, W, 3) + per-lane
    saved A (L, 3) -> (t (L, B, H, W), t_min (L, B), cand_rgb (L, B, 3));
    each lane's DCP pre-map divides by its own A, all lanes in one pass
    sequence."""
    if img.dim() != 5:
        raise ValueError(f"expected (L, B, H, W, 3) frames, got {tuple(img.shape)}")
    fn = (_ref.fused_transmission_lanes if resolve_mode(mode) == "ref"
          else _fused.fused_transmission_lanes)
    return fn(img, A_saved, algorithm=algorithm, radius=radius, omega=omega,
              beta=beta, cap_w=tuple(cap_w), refine=refine,
              gf_radius=gf_radius, gf_eps=gf_eps, topk=topk,
              out_dtype=out_dtype)


def fused_transmission_halo(img: torch.Tensor, pre_ext: torch.Tensor,
                            guide_ext: torch.Tensor, valid: torch.Tensor,
                            valid_w: Optional[torch.Tensor] = None, *,
                            algorithm: str = "dcp", radius: int,
                            omega: float = 0.95, beta: float = 1.0,
                            refine: bool, gf_radius: int, gf_eps: float,
                            topk: int = 1, out_dtype: Optional[str] = "auto",
                            mode: Mode = "auto", tile: Optional[str] = None,
                            blocks_per_sm: Optional[int] = None,
                            tuned: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """One spatial shard's fused transmission stage: (..., h, w, 3) core
    frames, (..., h_ext, w_ext) halo-extended pre-map and luma planes,
    (h_ext,) row and optional (w_ext,) column validity -> ``(t, tk_t
    (..., k), tk_rgb (..., k, 3), tk_idx (..., k))``, the shard's k
    smallest (t_raw, local flat index), ascending. ``tile`` and
    ``blocks_per_sm`` are the tiled passes' knobs (None: op
    ``fused_halo_2d`` of the tuning table at the flat (N, h, w) and wire
    dtype; ``tuned`` as in :func:`fused_dehaze`)."""
    flat, lead = _batched(img, 3)
    flat_pre, _ = _batched(pre_ext, 2)
    flat_guide, _ = _batched(guide_ext, 2)
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              refine=refine, gf_radius=gf_radius, gf_eps=gf_eps, topk=topk,
              out_dtype=out_dtype)
    fn = _ref.fused_transmission_halo
    if resolve_mode(mode) != "ref":
        fn = _fused.fused_transmission_halo
        kw.update(_knobs("fused_halo_2d", flat.shape[:3], flat.dtype,
                         img.device, tuned, tile=tile,
                         blocks_per_sm=blocks_per_sm))
    t, tk_t, tk_rgb, tk_idx = fn(flat, flat_pre, flat_guide, valid, valid_w,
                                 **kw)
    return (t.reshape(lead + tuple(t.shape[1:])), tk_t.reshape(lead + (topk,)),
            tk_rgb.reshape(lead + (topk, 3)), tk_idx.reshape(lead + (topk,)))


def fused_dehaze_dcp(img: torch.Tensor, frame_ids: torch.Tensor,
                     A_saved: torch.Tensor, last_update: torch.Tensor,
                     initialized: torch.Tensor, *, frames_per_block: int = 0,
                     **kw) -> Tuple[torch.Tensor, ...]:
    """Back-compat entry point (the reference's first, DCP-only name) ->
    :func:`fused_dehaze` with ``algorithm="dcp"``. ``frames_per_block`` is
    a TPU tiling knob with no meaning here: only its default 0 is taken."""
    if frames_per_block != 0:
        raise ValueError(
            f"frames_per_block={frames_per_block}: the TPU's frames-per-block "
            "tiling has no counterpart in repro_torch; pass 0 (the default)")
    return fused_dehaze(img, frame_ids, A_saved, last_update, initialized,
                        algorithm="dcp", **kw)


def fused_transmission_dcp(img: torch.Tensor, A_saved: torch.Tensor,
                           **kw) -> Tuple[torch.Tensor, ...]:
    """Back-compat entry point (the reference's first, DCP-only name) ->
    :func:`fused_transmission` with ``algorithm="dcp"``."""
    return fused_transmission(img, A_saved, algorithm="dcp", **kw)


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

def launch_counters() -> Dict[str, int]:
    """Every hand-written kernel's launches so far, by name: the
    megakernel's passes by their own names, ``fused_transmission.<pass>``
    and ``fused_transmission_halo.<pass>`` (the transmission stage and its
    halo form), ``staged.<kernel>``. Of a staged kernel's launches, those
    of the route past its limits are also in ``staged.wide_launches``."""
    with _staged.launch_lock:
        counts = dict(_fused.launches)
        for prefix, table in (
                ("fused_transmission", _fused.transmission_launches),
                ("fused_transmission_halo", _fused.halo_launches),
                ("staged", _staged.launches)):
            counts.update({f"{prefix}.{k}": n for k, n in table.items()})
    return counts


def launch_count(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Call ``fn(*args, **kwargs)`` once and return the hand-written kernel
    launches it made: ``{name: n}`` for each kernel that launched (names as
    :func:`launch_counters` gives them) and ``"total"``.

    The counterpart of the reference's ``pallas_launch_count``, but a count
    of launches, not a trace of a program: it takes the counters before
    and after the call and resets none, so other readers keep their
    counts. Every launch in the process during the call counts, other
    threads' too. On CPU tensors the plain versions run and launch no
    kernel: the count is 0."""
    before = launch_counters()
    fn(*args, **kwargs)
    after = launch_counters()
    counts = {k: n - before[k] for k, n in after.items() if n != before[k]}
    counts["total"] = sum(counts.values())
    return counts


__all__ = ["MODES", "resolve_mode", "dark_channel", "min_filter_2d",
           "box_filter_2d", "masked_min_filter_2d", "masked_box_filter_2d",
           "guided_filter", "masked_guided_filter", "atmospheric_light",
           "merge_topk_candidates", "merge_ema",
           "per_frame", "recover",
           "cap_depth", "fused_dehaze", "fused_dehaze_lanes",
           "fused_transmission", "fused_transmission_lanes",
           "fused_transmission_halo", "fused_dehaze_dcp",
           "fused_transmission_dcp", "launch_counters", "launch_count"]
