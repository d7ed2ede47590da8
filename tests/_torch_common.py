"""Shared inputs of the PyTorch-port differential tests (tests/test_torch_*).

The inputs are numpy arrays made from seeds; each test hands the same
arrays to the JAX package and to the port.
"""
import numpy as np
import torch

import jax.numpy as jnp


def ramp_frames(seed, *lead, h, w):
    """Tie-stable frames (the recipe of ``conftest.ramp_frames``, as numpy):
    a seeded permutation gray ramp, all levels distinct, with channel
    scales (1.0, 0.9, 0.8), shaped ``lead + (h, w, 3)``."""
    r = np.random.default_rng(seed)
    n = int(np.prod(lead)) * h * w
    g = (r.permutation(n).reshape(*lead, h, w) + 1.0) / (n + 1.0)
    return np.stack([g, 0.9 * g, 0.8 * g], axis=-1).astype(np.float32)


def wire(x: np.ndarray, dtype: str):
    """The same float frames in a wire dtype, for both packages:
    ``(jax array, torch tensor)``."""
    if dtype == "uint8":
        q = np.clip(np.round(x * np.float32(255.0)), 0, 255).astype(np.uint8)
        return jnp.asarray(q), torch.from_numpy(q)
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return jnp.asarray(x).astype(jnp.bfloat16), t
    return jnp.asarray(x), torch.from_numpy(x.copy())


def as_np(a) -> np.ndarray:
    """JAX array or torch tensor -> float32 (or native int/bool) numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
