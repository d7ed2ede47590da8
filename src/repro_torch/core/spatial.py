"""Halo exchange and masked separable filters of the spatially sharded
step, PyTorch port.

The reference (``repro/core/spatial.py``) shards image height and width
over mesh axes, exchanges halos with ``lax.ppermute`` and runs the windowed
filters under separable row/column validity masks, so a shard at the mesh
edge keeps the global border semantics (clipped windows): the min filter
treats invalid rows/columns as +inf, the box filter leaves them out of
both the sum and the count.

The masked filters here are the plain versions: the reference computes
them with XLA ``reduce_window`` in its sharded step, and its Pallas kernels
of the same functions (``masked_min_filter_2d_pallas``,
``masked_box_filter_2d_pallas``) are ported as ``ops.masked_min_filter_2d``
/ ``ops.masked_box_filter_2d`` (``kernels.staged``). The staged branch of
the sharded steps (``core.pipeline``) takes the filters through ``ops``:
their kernels on the card, and these under ``kernel_mode="ref"``.

The halo exchange (:func:`halo_exchange_along` and its height and width
views) moves ``halo`` slices from each side over ``torch.distributed``
point-to-point operations on the process group of one mesh axis: a halo
wider than a shard comes as ``ceil(halo / size)`` transfers a side, the one
from ``s`` shards away carrying only the slices needed, all posted in one
``batch_isend_irecv`` so no two ranks wait on each other. A missing
neighbour gives zeros, as ``ppermute`` does, and its slices are marked
invalid.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# Halo exchange along a mesh axis that shards image height or width
# ---------------------------------------------------------------------------

def halo_exchange_along(x: torch.Tensor, halo: int, mesh, axis_name: str,
                        dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extend this rank's block with ``halo`` slices of context from each
    side along ``dim`` (1 = image height, 2 = image width).

    ``x``'s ``dim`` is sharded over the mesh axis ``axis_name`` (the
    axis's rank 0 holds the leading slices). Returns ``(x_ext, valid)``:
    ``x_ext`` grows ``dim`` by ``2 * halo`` and ``valid`` (size + 2 halo,)
    marks the slices that exist in the global image. Every rank of the
    axis must call it with the same shapes."""
    size = x.shape[dim]
    if halo == 0:
        return x, torch.ones(size, dtype=torch.bool, device=x.device)
    group = mesh.get_group(axis_name)
    peers = dist.get_process_group_ranks(group)       # global, in axis order
    n, idx = len(peers), mesh.get_local_rank(axis_name)
    ops, lead, trail = [], [], []
    for s in range(math.ceil(halo / size), 0, -1):
        # Slices from the shard s before us: its last c_s ones.
        c_s = min(size, halo - (s - 1) * size)
        shape = list(x.shape)
        shape[dim] = c_s
        from_before = x.new_zeros(shape)
        from_after = x.new_zeros(shape)
        if idx + s < n:
            ops += [dist.P2POp(dist.isend,
                               x.narrow(dim, size - c_s, c_s).contiguous(),
                               peers[idx + s], group),
                    dist.P2POp(dist.irecv, from_after, peers[idx + s], group)]
        if idx - s >= 0:
            ops += [dist.P2POp(dist.isend, x.narrow(dim, 0, c_s).contiguous(),
                               peers[idx - s], group),
                    dist.P2POp(dist.irecv, from_before, peers[idx - s], group)]
        lead.append((from_before, idx >= s, c_s))
        trail.append((from_after, idx < n - s, c_s))
    for req in (dist.batch_isend_irecv(ops) if ops else ()):
        req.wait()
    parts = lead + [(x, True, size)] + trail[::-1]
    x_ext = torch.cat([p for p, _, _ in parts], dim=dim)
    valid = torch.cat([torch.full((c,), ok, dtype=torch.bool, device=x.device)
                       for _, ok, c in parts])
    return x_ext, valid


def halo_exchange_height(x: torch.Tensor, halo: int, mesh,
                         axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, h, W, C) block, height sharded over ``axis_name`` -> the
    height-extended block and its (h + 2 halo,) row validity."""
    return halo_exchange_along(x, halo, mesh, axis_name, dim=1)


def halo_exchange_width(x: torch.Tensor, halo: int, mesh,
                        axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, w, C) block, width sharded over ``axis_name`` -> the
    width-extended block and its (w + 2 halo,) column validity. Run after
    the height exchange when both are sharded: the height-extended block
    rides this exchange, so the corner halos need no transfer of their
    own."""
    return halo_exchange_along(x, halo, mesh, axis_name, dim=2)


__all__ = ["masked_min_filter_2d", "masked_box_filter_2d",
           "masked_guided_filter", "halo_exchange_along",
           "halo_exchange_height", "halo_exchange_width"]
