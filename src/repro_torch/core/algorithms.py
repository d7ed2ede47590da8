"""The three generic dehazing components (paper §3.1) + DCP/CAP instances.

Component protocol (batched over leading frame axes, images NHWC):

  TransmissionEstimator:     (frames, A_saved, cfg) -> t_raw
  AtmosphericLightEstimator: (frames, t_raw, cfg)   -> A_new
  HazeFreeGenerator:         (frames, t, A, cfg)    -> J

Estimators are black boxes to the framework; new ones register through
``register_algorithm``. The staged estimators sit on ``kernels.ops``
(the staged CUDA kernels, or the plain chain under ``ref``); the fused
path runs all three components and the §3.3 EMA as the megakernel.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.config import DehazeConfig
from repro_torch.core.normalize import (AtmoState, lane_carry,
                                        state_from_lane_carry)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

TransmissionEstimator = Callable[[torch.Tensor, torch.Tensor, DehazeConfig],
                                 torch.Tensor]


def luminance(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma, the guided-filter guide."""
    return kref.luminance(img).to(img.dtype)


# ---------------------------------------------------------------------------
# Transmission map estimators (component 1)
# ---------------------------------------------------------------------------

def transmission_dcp(frames: torch.Tensor, a_saved: torch.Tensor,
                     cfg: DehazeConfig) -> torch.Tensor:
    """DCP, Eq. 3: t = 1 - ω · min_Ω min_c I^c/A^c, with the *saved*
    shared A (§3.3: the estimator runs before the A refresh). ``a_saved``
    is one stream's (3,), one row per lane (L, 3) against (L, B, H, W, 3)
    frames, or one row per frame."""
    a = ops.per_frame(torch.clamp_min(a_saved, 1e-3),
                      tuple(frames.shape[:-3]))
    norm = frames / a[..., None, None, :]
    dark = ops.dark_channel(norm, cfg.patch_radius, cfg.kernel_mode)
    return (1.0 - cfg.omega * dark).to(frames.dtype)


def transmission_cap(frames: torch.Tensor, a_saved: torch.Tensor,
                     cfg: DehazeConfig) -> torch.Tensor:
    """CAP, Eq. 4: t = exp(-β (ω0 + ω1 v + ω2 s)), min-filtered depth."""
    del a_saved                                        # CAP's t is A-free
    d = ops.cap_depth(frames, cfg.cap_w0, cfg.cap_w1, cfg.cap_w2)
    d = ops.min_filter_2d(d, cfg.patch_radius, cfg.kernel_mode)
    return torch.exp(-cfg.beta * d).to(frames.dtype)


_ALGORITHMS: Dict[str, TransmissionEstimator] = {}


def register_algorithm(name: str, estimator: TransmissionEstimator) -> None:
    _ALGORITHMS[name] = estimator


def get_transmission_estimator(name: str) -> TransmissionEstimator:
    try:
        return _ALGORITHMS[name]
    except KeyError:
        raise KeyError(f"unknown dehazing algorithm {name!r}; "
                       f"registered: {sorted(_ALGORITHMS)}") from None


register_algorithm("dcp", transmission_dcp)
register_algorithm("cap", transmission_cap)


# ---------------------------------------------------------------------------
# Components 2 and 3, and the guided-filter refinement
# ---------------------------------------------------------------------------

def estimate_atmospheric_light(frames: torch.Tensor, t_raw: torch.Tensor,
                               cfg: DehazeConfig,
                               tuned: Optional[dict] = None) -> torch.Tensor:
    """Eq. 5/6: A = I at the pixel(s) of minimum raw transmission.
    ``tuned``: the caller's resolved kernel knobs (``ops.fused_dehaze``)."""
    return ops.atmospheric_light(frames, t_raw, cfg.topk, cfg.kernel_mode,
                                 tuned=tuned)


def refine_transmission(frames: torch.Tensor, t_raw: torch.Tensor,
                        cfg: DehazeConfig) -> torch.Tensor:
    if not cfg.refine:
        return t_raw
    t = ops.guided_filter(luminance(frames), t_raw, cfg.gf_radius,
                          cfg.gf_eps, cfg.kernel_mode)
    return torch.clamp(t, 0.0, 1.0)


def generate_haze_free(frames: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
                       cfg: DehazeConfig,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8 with the serving tone-curve epilogue; ``A`` as in
    :func:`transmission_dcp` (per frame: (B, 3) or (L, B, 3)). J goes into
    ``out`` where given (``frames`` itself under buffer donation)."""
    return ops.recover(frames, t, A, cfg.t0, cfg.gamma, cfg.kernel_mode,
                       out=out)


# ---------------------------------------------------------------------------
# The fused path (all three components in one megakernel)
# ---------------------------------------------------------------------------

def supports_fused(cfg: DehazeConfig) -> bool:
    """The megakernel covers DCP and CAP with any top-k; the one fallback
    is DCP with ``recompute_t_with_final_a`` (inherently two-stage). CAP's
    transmission is A-free, so the flag does not gate it."""
    return (cfg.algorithm in ("dcp", "cap")
            and not (cfg.algorithm == "dcp" and cfg.recompute_t_with_final_a))


def premap(frames: torch.Tensor, a_saved: torch.Tensor,
           cfg: DehazeConfig) -> torch.Tensor:
    """Per-pixel stage-1 pre-map (``kernels.ref.premap``)."""
    a0 = torch.clamp_min(a_saved, 1e-3)
    return kref.premap(frames, a0, cfg.algorithm,
                       (cfg.cap_w0, cfg.cap_w1, cfg.cap_w2))


def _fused_kw(cfg: DehazeConfig) -> dict:
    return dict(algorithm=cfg.algorithm, radius=cfg.patch_radius,
                omega=cfg.omega, beta=cfg.beta,
                cap_w=(cfg.cap_w0, cfg.cap_w1, cfg.cap_w2),
                refine=cfg.refine, gf_radius=cfg.gf_radius, gf_eps=cfg.gf_eps,
                t0=cfg.t0, gamma=cfg.gamma, period=cfg.update_period,
                lam=cfg.lam, topk=cfg.topk, out_dtype=cfg.out_dtype,
                mode=cfg.kernel_mode)


def fused_dehaze(frames: torch.Tensor, frame_ids: torch.Tensor,
                 state: AtmoState, cfg: DehazeConfig,
                 out: Optional[torch.Tensor] = None,
                 tuned: Optional[dict] = None):
    """Components 1-3 + the §3.3 EMA as one fused op: (J, t, a_seq, new
    state). ``initialized`` flips only once a valid (id >= 0) frame was
    folded in. J goes into ``out`` where given. ``tuned``: the caller's
    resolved kernel knobs (``ops.fused_dehaze``)."""
    J, t, a_seq, a_fin, k_fin = ops.fused_dehaze(
        frames, frame_ids, state.A, state.last_update, state.initialized,
        out=out, tuned=tuned, **_fused_kw(cfg))
    ids = frame_ids.to(a_fin.device)
    new_state = AtmoState(
        A=a_fin, last_update=k_fin,
        initialized=state.initialized.to(a_fin.device) | (ids >= 0).any())
    return J, t, a_seq, new_state


def fused_dehaze_lanes(frames: torch.Tensor, frame_ids: torch.Tensor,
                       state: AtmoState, cfg: DehazeConfig,
                       out: Optional[torch.Tensor] = None,
                       tuned: Optional[dict] = None):
    """Lane-native fused path: L streams in one megakernel call.
    ``frames`` (L, B, H, W, 3), ``frame_ids`` (L, B), lane-batched
    ``state``; per lane the same as :func:`fused_dehaze` on that lane. J
    goes into ``out`` where given; ``tuned`` as in :func:`fused_dehaze`."""
    carry_f, carry_i = lane_carry(state)
    J, t, a_seq, cf, ci = ops.fused_dehaze_lanes(
        frames, frame_ids, carry_f, carry_i, out=out, tuned=tuned,
        **_fused_kw(cfg))
    return J, t, a_seq, state_from_lane_carry(cf, ci)


def _transmission_kw(cfg: DehazeConfig) -> dict:
    """:func:`_fused_kw` less the EMA and recovery constants."""
    kw = _fused_kw(cfg)
    for k in ("t0", "gamma", "period", "lam"):
        del kw[k]
    return kw


def fused_transmission(frames: torch.Tensor, a_saved: torch.Tensor,
                       cfg: DehazeConfig):
    """Fused t-map + A-candidate stage of the data-parallel sharded step:
    (B, H, W, 3) + saved A (3,) -> (t, t_min (B,), cand_rgb (B, 3))."""
    return ops.fused_transmission(frames, a_saved, **_transmission_kw(cfg))


def fused_transmission_lanes(frames: torch.Tensor, a_saved: torch.Tensor,
                             cfg: DehazeConfig):
    """Per-lane saved-A form: (L, B, H, W, 3) + (L, 3) -> (t, t_min,
    cand_rgb) with a leading lane axis, the lane-sharded step's stage
    (lanes are whole on their rank, so the candidates need no merge)."""
    return ops.fused_transmission_lanes(frames, a_saved,
                                        **_transmission_kw(cfg))


def fused_transmission_halo(frames: torch.Tensor, pre_ext: torch.Tensor,
                            guide_ext: torch.Tensor, valid: torch.Tensor,
                            valid_w, cfg: DehazeConfig,
                            tuned: Optional[dict] = None):
    """Fused transmission stage of one spatial shard: the halo-extended
    (pre-map, luma) planes from the exchange and their row/column validity
    (``valid_w=None``: no width sharding) -> ``(t, tk_t, tk_rgb, tk_idx)``,
    the shard-local top-k lists (``ops.fused_transmission_halo``);
    ``tuned`` as in :func:`fused_dehaze`."""
    kw = _transmission_kw(cfg)
    del kw["cap_w"]                      # the pre-map is an input here
    return ops.fused_transmission_halo(frames, pre_ext, guide_ext, valid,
                                       valid_w, tuned=tuned, **kw)


__all__ = ["luminance", "transmission_dcp", "transmission_cap",
           "register_algorithm", "get_transmission_estimator",
           "estimate_atmospheric_light", "refine_transmission",
           "generate_haze_free", "supports_fused", "premap", "fused_dehaze",
           "fused_dehaze_lanes", "fused_transmission",
           "fused_transmission_lanes",
           "fused_transmission_halo"]
