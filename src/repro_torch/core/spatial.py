"""Masked separable filters of the spatially sharded step, PyTorch port.

The reference (``repro/core/spatial.py``) shards image height and width
over mesh axes, exchanges halos with ``lax.ppermute`` and runs the windowed
filters under separable row/column validity masks, so a shard at the mesh
edge keeps the global border semantics (clipped windows): the min filter
treats invalid rows/columns as +inf, the box filter leaves them out of
both the sum and the count.

Ported here: the three masked filters. The reference computes them with
XLA ``reduce_window``, not with a Pallas kernel, so their port is plain
PyTorch on any device, the card included; this is their implementation,
not a fallback for a missing kernel. The staged data-parallel sharded step
(``core.pipeline``) runs them with all-valid masks. The halo exchange and
the masked Pallas kernels (ROADMAP.md queue B, rows B8-B10) are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.staged import window_sum


def _mask_2d(valid: torch.Tensor,
             valid_w: Optional[torch.Tensor]) -> torch.Tensor:
    """(H,) row validity [x (W,) column validity] -> broadcastable (H, W)
    or (H, 1) mask."""
    mask = valid.to(torch.bool)[:, None]
    if valid_w is not None:
        mask = mask & valid_w.to(torch.bool)[None, :]
    return mask


def masked_min_filter_2d(x: torch.Tensor, valid: torch.Tensor, radius: int,
                         valid_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Windowed min over (..., H, W), invalid rows/columns as +inf; in
    float32, cast back to ``x``'s dtype."""
    xm = torch.where(_mask_2d(valid, valid_w), x.to(torch.float32),
                     torch.full((), torch.inf, device=x.device))
    return ref.min_filter_2d(xm, radius).to(x.dtype)


def masked_box_filter_2d(x: torch.Tensor, valid: torch.Tensor, radius: int,
                         valid_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Windowed mean over valid rows/columns only: the sum and the count
    both leave invalid pixels out."""
    mask = _mask_2d(valid, valid_w)
    # `where`, not multiply: invalid rows may hold +-inf from a masked min
    # filter upstream, and inf * 0 is NaN.
    xm = torch.where(mask, x.to(torch.float32), torch.zeros((), device=x.device))

    def wsum(a):
        return window_sum(window_sum(a, radius, -2), radius, -1)

    acc = wsum(xm)
    cnt = wsum(torch.broadcast_to(mask, x.shape).to(torch.float32))
    return (acc / torch.clamp_min(cnt, 1.0)).to(x.dtype)


def masked_guided_filter(guide: torch.Tensor, src: torch.Tensor,
                         valid: torch.Tensor, radius: int, eps: float,
                         valid_w: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Gray-guide guided filter with all five means over valid
    rows/columns only."""
    g = guide.to(torch.float32)
    p = src.to(torch.float32)

    def bf(a):
        return masked_box_filter_2d(a, valid, radius, valid_w)
    mean_g = bf(g)
    mean_p = bf(p)
    corr_gp = bf(g * p)
    corr_gg = bf(g * g)
    var_g = corr_gg - mean_g * mean_g
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + eps)
    b = mean_p - a * mean_g
    return (bf(a) * g + bf(b)).to(src.dtype)


__all__ = ["masked_min_filter_2d", "masked_box_filter_2d",
           "masked_guided_filter"]
