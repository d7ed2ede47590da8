"""Dispatch wrappers for the dehazing kernels (PyTorch port).

``mode`` selects how an op runs:

  - ``"ref"``    : the plain PyTorch chain (``kernels.ref``), any device;
  - ``"fused"``  : the whole chain as the hand-written CUDA megakernel
                   (``kernels.fused``) on CUDA tensors, its plain version on
                   CPU tensors;
  - ``"pallas"`` / ``"auto"``: the staged per-stage kernels, not ported yet
                   (ROADMAP.md queue B, rows B3-B6): raise
                   ``NotImplementedError``;
  - ``"interpret"``: a Pallas-on-CPU substrate with no counterpart here:
                   raises ``ValueError``.

``REPRO_KERNEL_MODE`` replaces ``"auto"`` and, set to ``ref``, sends
``"fused"`` to the plain chain, as on the reference. The TPU tiling knobs
(``frames_per_block``, ``lane_major``, ``buffer_depth``, the tuning
table) have no counterpart.
"""
from __future__ import annotations

from typing import Literal, Optional, Sequence, Tuple

import torch

from repro_torch.core import env as _env
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import CAP_COEFFS

Mode = Literal["auto", "ref", "pallas", "interpret", "fused"]

MODES = _env.KERNEL_MODES

_STAGED_TODO = ("the staged per-stage kernels (kernel_mode {mode!r}) are not "
                "ported yet (ROADMAP.md queue B, rows B3-B6); use "
                "kernel_mode='fused' or 'ref'")


def resolve_mode(mode: Mode = "auto") -> str:
    """Resolve to ``"ref"`` or ``"fused"``; raise for the rest (see the
    module docstring). Unknown values, in the argument or in
    ``REPRO_KERNEL_MODE``, raise ``ValueError``."""
    if mode not in MODES:
        raise ValueError(
            f"unknown kernel mode {mode!r}; expected one of {sorted(MODES)}")
    env = _env.kernel_mode()
    m = mode
    if m == "auto" and env not in ("", "auto"):
        m = env
    if m == "fused" and env == "ref":
        m = "ref"
    if m == "interpret":
        raise ValueError("kernel_mode 'interpret' runs Pallas kernel bodies "
                         "on the CPU and has no counterpart in repro_torch")
    if m in ("pallas", "auto"):
        raise NotImplementedError(_STAGED_TODO.format(mode=m))
    return m


def _staged(mode: Mode, x: torch.Tensor) -> None:
    """Staged ops run the plain version for ``ref``, and for ``fused`` on
    CPU tensors (the fused path's fallback configs); on CUDA their kernels
    are not ported yet."""
    m = resolve_mode(mode)
    if m == "fused" and x.device.type != "cpu":
        raise NotImplementedError(_STAGED_TODO.format(mode=m))


def _batched(x: torch.Tensor, rank: int):
    """Collapse leading dims so the ops always see (B, ...)."""
    lead = tuple(x.shape[: x.dim() - rank])
    return x.reshape((-1,) + tuple(x.shape[x.dim() - rank:])), lead


def dark_channel(img, radius: int, mode: Mode = "auto"):
    _staged(mode, img)
    return _ref.dark_channel(img, radius)


def min_filter_2d(x, radius: int, mode: Mode = "auto"):
    _staged(mode, x)
    return _ref.min_filter_2d(x, radius)


def guided_filter(guide, src, radius: int, eps: float, mode: Mode = "auto"):
    _staged(mode, src)
    return _ref.guided_filter(guide, src, radius, eps)


def atmospheric_light(img, t_raw, k: int = 1, mode: Mode = "auto"):
    _staged(mode, img)
    return _ref.atmospheric_light(img, t_raw, k)


def recover(img, t, A, t0: float = 0.1, gamma: float = 1.0,
            mode: Mode = "auto"):
    _staged(mode, img)
    out = _ref.recover(img, t, A, t0)
    return out ** gamma if gamma != 1.0 else out


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
                 mode: Mode = "auto") -> Tuple[torch.Tensor, ...]:
    """Whole DCP/CAP chain: (..., H, W, 3) -> (J, t, a_seq, A, k)."""
    m = resolve_mode(mode)
    flat, lead = _batched(img, 3)
    flat_ids = frame_ids.reshape(-1)
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=tuple(cap_w), refine=refine, gf_radius=gf_radius,
              gf_eps=gf_eps, t0=t0, gamma=gamma, period=period, lam=lam,
              topk=topk, out_dtype=out_dtype)
    fn = _ref.fused_dehaze if m == "ref" else _fused.fused_dehaze
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
                       mode: Mode = "auto") -> Tuple[torch.Tensor, ...]:
    """Lane-native fused dehaze: (L, B, H, W, 3), (L, B) ids and the
    (L, 3)/(L, 2) carry rows -> ``(J, t, a_seq (L, B, 3), carry_f',
    carry_i')``; per lane identical to :func:`fused_dehaze` on that lane,
    padding lanes (all ids < 0) untouched."""
    if img.dim() != 5:
        raise ValueError(f"expected (L, B, H, W, 3) frames, got {tuple(img.shape)}")
    m = resolve_mode(mode)
    kw = dict(algorithm=algorithm, radius=radius, omega=omega, beta=beta,
              cap_w=tuple(cap_w), refine=refine, gf_radius=gf_radius,
              gf_eps=gf_eps, t0=t0, gamma=gamma, period=period, lam=lam,
              topk=topk, out_dtype=out_dtype)
    fn = _ref.fused_dehaze_lanes if m == "ref" else _fused.fused_dehaze_lanes
    return fn(img, frame_ids, carry_f, carry_i, **kw)


__all__ = ["MODES", "resolve_mode", "dark_channel", "min_filter_2d",
           "guided_filter", "atmospheric_light", "recover",
           "cap_depth", "fused_dehaze", "fused_dehaze_lanes"]
