"""Shared inputs of the PyTorch-port differential tests (tests/test_torch_*).

The inputs are numpy arrays made from seeds; each test hands the same
arrays to the JAX package and to the port. ``launch_counters_restored``
keeps the kernels' launch counters from one test out of the next.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.kernels import fused, staged


def _counter_tables():
    """Every module-level launch counter of the port: the tables that
    ``ops.launch_counters()`` lists, the staged kernels' wide routes and
    the megakernel's launches by library variant."""
    return (staged.launches, staged.wide_launches, fused.launches,
            fused.transmission_launches, fused.halo_launches,
            fused.variant_launches)


def counter_snapshot():
    """A copy of every launch counter, to compare with a later one."""
    return tuple(dict(t) for t in _counter_tables())


@pytest.fixture(autouse=True)
def launch_counters_restored():
    """Put every launch counter back as it was before the test, whatever
    the test raised, reset or seeded. Autouse in each file that imports
    it, so a count read in one test never holds another test's launches."""
    saved = counter_snapshot()
    yield
    with staged.launch_lock:
        for table, counts in zip(_counter_tables(), saved):
            table.clear()
            table.update(counts)


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
