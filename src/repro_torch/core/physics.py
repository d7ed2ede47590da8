"""Atmospheric scattering model (paper Eqs. 1, 2 and 8), on tensors.

Images are float tensors in [0, 1], laid out ``(..., H, W, 3)`` (NHWC for
batches of frames); transmission maps are ``(..., H, W)``. The port's own
copy of the JAX package's ``core/physics.py``.
"""
from __future__ import annotations

import torch

# Lower bound on the transmission in the haze-free generator (paper Eq. 8).
DEFAULT_T0 = 0.1


def synthesize_haze(clear: torch.Tensor, t: torch.Tensor,
                    A: torch.Tensor) -> torch.Tensor:
    """Forward model, paper Eq. 1: ``I(x) = J(x) t(x) + A (1 - t(x))``.

    ``clear`` is the haze-free radiance J (..., H, W, 3), ``t`` the
    transmission (..., H, W), ``A`` the atmospheric light (..., 3) or (3,).
    """
    t = t[..., None]
    A = A[..., None, None, :].expand(clear.shape)
    return clear * t + A * (1.0 - t)


def transmission_from_depth(depth: torch.Tensor, beta: float) -> torch.Tensor:
    """Paper Eq. 2: ``t(x) = exp(-beta d(x))``."""
    return torch.exp(-beta * depth)


def recover(hazy: torch.Tensor, t: torch.Tensor, A: torch.Tensor,
            t0: float = DEFAULT_T0) -> torch.Tensor:
    """The haze-free image generator, paper Eq. 8:
    ``J(x) = (I(x) - A) / max(t(x), t0) + A``, clipped to [0, 1]."""
    t = torch.clamp_min(t, t0)[..., None]
    A = A[..., None, None, :].expand(hazy.shape)
    return torch.clamp((hazy - A) / t + A, 0.0, 1.0)


__all__ = ["DEFAULT_T0", "synthesize_haze", "transmission_from_depth",
           "recover"]
