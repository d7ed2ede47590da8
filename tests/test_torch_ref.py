"""PyTorch port, plain versions: ``repro_torch.kernels.ref`` against the
JAX package's ``repro.kernels.ref`` on the same numpy inputs.

Selections (min filters, argmin / top-k picks) are held exactly on the
tie-stable ramp frames; sums to float32 round-off.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

from _torch_common import as_np, ramp_frames, wire

torch.set_num_threads(1)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_upcast_and_out_dtype(dtype):
    x = ramp_frames(0, 2, h=8, w=10)
    jx, tx = wire(x, dtype)
    np.testing.assert_array_equal(as_np(jref.upcast_frames(jx)),
                                  as_np(tref.upcast_frames(tx)))
    want = jref.resolve_out_dtype(jx.dtype, None)
    assert str(tref.resolve_out_dtype(dtype)).endswith(str(want))
    assert tref.resolve_out_dtype(dtype, "bfloat16") == torch.bfloat16


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
def test_quantize_frames_matches(dtype):
    x = np.random.default_rng(1).random((3, 5, 4, 3)).astype(np.float32)
    x[0, 0, 0] = [1.2, -0.1, 0.5]                # out-of-range and a tie
    want = as_np(jref.quantize_frames(x, dtype))
    got = tref.quantize_frames(x, dtype)
    assert got.dtype == tref.as_torch_dtype(dtype)
    np.testing.assert_array_equal(as_np(got), want)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_min_filter_and_dark_channel_exact(radius):
    x = ramp_frames(2, 2, h=13, w=17)
    jx, tx = _pair(x)
    np.testing.assert_array_equal(
        as_np(tref.min_filter_2d(tx[..., 0], radius)),
        as_np(jref.min_filter_2d(jx[..., 0], radius)))
    np.testing.assert_array_equal(as_np(tref.dark_channel(tx, radius)),
                                  as_np(jref.dark_channel(jx, radius)))


@pytest.mark.parametrize("radius", [1, 4])
def test_box_and_guided_filter(radius):
    x = np.random.default_rng(3).random((2, 12, 15, 3)).astype(np.float32)
    jx, tx = _pair(x)
    np.testing.assert_allclose(
        as_np(tref.box_filter_2d(tx[..., 0], radius)),
        as_np(jref.box_filter_2d(jx[..., 0], radius)), atol=1e-6)
    got = tref.guided_filter(tref.luminance(tx), tx[..., 1], radius, 1e-3)
    want = jref.guided_filter(jref.luminance(jx), jx[..., 1], radius, 1e-3)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_atmospheric_light_picks_match(k):
    x = ramp_frames(4, 3, h=10, w=12)
    jx, tx = _pair(x)
    # A min-filtered t has plateaus: ties must go to the lowest index.
    jt = jref.min_filter_2d(jref.premap(jx, jnp.ones(3), "dcp"), 2)
    tt = tref.min_filter_2d(tref.premap(tx, torch.ones(3), "dcp"), 2)
    np.testing.assert_array_equal(as_np(tt), as_np(jt))
    np.testing.assert_allclose(as_np(tref.atmospheric_light(tx, tt, k)),
                               as_np(jref.atmospheric_light(jx, jt, k)),
                               atol=1e-7, rtol=0)


def test_pointwise_maps():
    x = ramp_frames(5, 2, h=6, w=7)
    x[0, 0, 0] = 0.0                              # saturation's v == 0 branch
    jx, tx = _pair(x)
    a0 = np.asarray([0.7, 0.8, 0.9], np.float32)
    for alg in ("dcp", "cap"):
        jp = jref.premap(jx, jnp.asarray(a0), alg)
        tp = tref.premap(tx, torch.from_numpy(a0), alg)
        np.testing.assert_allclose(as_np(tp), as_np(jp), atol=1e-7, rtol=0)
        np.testing.assert_allclose(
            as_np(tref.tmap_from_dark(tp, alg, 0.95, 1.2)),
            as_np(jref.tmap_from_dark(jp, alg, 0.95, 1.2)), atol=1e-6)
    np.testing.assert_allclose(as_np(tref.luminance(tx)),
                               as_np(jref.luminance(jx)), atol=1e-7)
    t = np.clip(x[..., 0], 0.05, 1.0)
    A = np.asarray([[0.9, 0.8, 0.7], [0.6, 0.7, 0.8]], np.float32)
    np.testing.assert_allclose(
        as_np(tref.recover(tx, torch.from_numpy(t), torch.from_numpy(A))),
        as_np(jref.recover(jx, jnp.asarray(t), jnp.asarray(A))), atol=1e-6)


@pytest.mark.parametrize("algorithm,topk,refine",
                         [("dcp", 1, True), ("cap", 4, False)])
def test_fused_transmission(algorithm, topk, refine):
    x = ramp_frames(6, 3, h=16, w=20)
    jx, tx = _pair(x)
    kw = dict(algorithm=algorithm, radius=3, omega=0.95, beta=1.2,
              refine=refine, gf_radius=4, gf_eps=1e-3, topk=topk)
    a = np.asarray([0.8, 0.85, 0.9], np.float32)
    got = tref.fused_transmission(tx, torch.from_numpy(a), **kw)
    want = jref.fused_transmission(jx, jnp.asarray(a), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5)


def test_fused_dehaze_real_radii():
    """The serving radii (patch 7, guided filter 20) on one 64x80 frame."""
    x = ramp_frames(7, 1, h=64, w=80)
    jx, tx = _pair(x)
    kw = dict(algorithm="dcp", radius=7, omega=0.95, refine=True,
              gf_radius=20, gf_eps=1e-3, t0=0.1, gamma=1.0, period=8,
              lam=0.05)
    A = np.ones(3, np.float32)
    got = tref.fused_dehaze(tx, torch.tensor([0], dtype=torch.int32),
                            torch.from_numpy(A),
                            torch.tensor(-(2 ** 30), dtype=torch.int32),
                            torch.tensor(False), **kw)
    want = jref.fused_dehaze(jx, jnp.asarray([0], jnp.int32), jnp.asarray(A),
                             jnp.asarray(-(2 ** 30), jnp.int32),
                             jnp.asarray(False), **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-4)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5)
