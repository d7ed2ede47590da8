"""PyTorch port, the staged component chain (``kernel_mode`` "auto" and
"pallas"): ``repro_torch.kernels.staged`` and the staged steps against the
JAX package's Pallas kernels and steps in interpret mode, on the same numpy
inputs.

On the CPU each wrapper runs its plain version, which follows its Pallas
kernel's arithmetic; the CUDA kernels (``csrc/staged.cu``) are held against
those plain versions on the card (``chip_smoke.py``, and the ``cuda``-marked
test below). Tolerances: selections (dark channel, min filter,
atmospheric light, the top-k's picks) exact; the top-k mean 1e-6 (float32;
the k picks summed in another order); box filter 1e-5 (float32; its direct
sums against the Pallas kernel's cumsum differences); recover 1e-6
(float32); guided filter 1e-4 as ``tests/test_kernels.py``; steps J/t 2e-4,
A 1e-5, ``last_update`` exact; bfloat16 2e-2 throughout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import DehazeConfig as JaxConfig
from repro.core import init_atmo_state as jax_init
from repro.core import init_atmo_state_lanes as jax_init_lanes
from repro.core import make_dehaze_step as jax_single_step
from repro.core import make_multi_stream_step as jax_multi_step
from repro.kernels import ops as jops
from repro.kernels.atmolight import atmolight_pallas, atmolight_topk_pallas
from repro.kernels.boxfilter import box_filter_2d_pallas
from repro.kernels.dark_channel import dark_channel_pallas, min_filter_2d_pallas
from repro.kernels.recover import recover_pallas
from repro.stream import ElasticServer as JaxServer
from repro.stream import StreamRequest as JaxRequest
from repro_torch.core import (DehazeConfig, init_atmo_state,
                              init_atmo_state_lanes, make_dehaze_step,
                              make_multi_stream_step)
from repro_torch.kernels import _build, staged
from repro_torch.kernels import ops as tops
from repro_torch.stream import ElasticServer, StreamRequest, StreamStateStore

from _torch_common import as_np, counter_snapshot, ramp_frames, wire
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

# (shape, radius): a plain cell, windows wider than the frame, radius 0.
WINDOWS = [((2, 24, 32), 3), ((1, 16, 20), 12), ((2, 12, 16), 0)]
STEP_CFG = dict(patch_radius=2, gf_radius=3, update_period=2, lam=0.3)


def _maps(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _tol(dtype, f32_tol):
    return 2e-2 if dtype == "bfloat16" else f32_tol


# --- each kernel's plain version against its Pallas kernel ------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,radius", WINDOWS)
def test_dark_channel_matches_pallas(shape, radius, dtype):
    jx, tx = wire(ramp_frames(1, shape[0], h=shape[1], w=shape[2]), dtype)
    got = staged.dark_channel_op(tx, radius)
    want = dark_channel_pallas(jx, radius, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(as_np(got), as_np(want))


# (shape, radius) of the min filter: radius 0, 1 and 7, and a window wider
# than the frame.
MIN_WINDOWS = [((2, 12, 16), 0), ((2, 24, 32), 1), ((2, 24, 32), 7),
               ((1, 10, 12), 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,radius", MIN_WINDOWS)
def test_min_filter_matches_pallas(shape, radius, dtype):
    jx, tx = wire(_maps(11, shape) - 0.25, dtype)
    got = staged.min_filter_op(tx, radius)
    want = min_filter_2d_pallas(jx, radius, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,radius", WINDOWS)
def test_box_filter_matches_pallas(shape, radius, dtype):
    jx, tx = wire(_maps(2, shape), dtype)
    got = staged.box_filter_op(tx, radius)
    want = box_filter_2d_pallas(jx, radius, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                               atol=_tol(dtype, 1e-5))


def _ascending_box_filter(v, r):
    """The box filter as a per-pixel float32 loop: the clipped horizontal
    window of each row the vertical window touches, then the column of
    those sums, each added in ascending order from +0, divided by the
    in-bounds count."""
    f = np.float32
    n, h, w = v.shape
    out = np.empty_like(v)
    for b, y, x in np.ndindex(n, h, w):
        rows = range(max(y - r, 0), min(y + r, h - 1) + 1)
        cols = range(max(x - r, 0), min(x + r, w - 1) + 1)
        s = f(0.0)
        for k in rows:
            hs = f(0.0)
            for c in cols:
                hs = f(hs + v[b, k, c])
            s = f(s + hs)
        out[b, y, x] = s / (f(len(rows)) * f(len(cols)))
    return out


@pytest.mark.parametrize("radius", [0, 2, 7])
def test_plain_box_filter_sums_in_the_kernel_order(radius):
    """The plain box filter, which the kernel must equal bit for bit on the
    card, is the ascending per-pixel sum bit for bit: negative values, a
    -0.0 column and row, a -0.0 block (its r = 0 means are +0.0), and at
    r = 7 windows wider than the 9 x 11 frame."""
    v = _maps(6, (2, 9, 11)) - 0.5
    v[0, :, 3] = -0.0
    v[0, 4, :] = 0.0
    v[1, :3, :3] = -0.0
    got = staged.plain_box_filter(torch.from_numpy(v), radius).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _ascending_box_filter(v, radius).view(np.uint32))


def _ascending_masked_box_filter(v, vr, vc, r):
    """The masked box filter as a per-pixel float32 loop: over the clipped
    window, the valid pixels of each valid row added in ascending column
    order from +0, then those row sums in ascending row order, divided by
    max(valid rows x valid columns, 1); invalid pixels never read."""
    f = np.float32
    n, h, w = v.shape
    out = np.empty_like(v)
    for b, y, x in np.ndindex(n, h, w):
        rows = [k for k in range(max(y - r, 0), min(y + r, h - 1) + 1) if vr[k]]
        cols = [c for c in range(max(x - r, 0), min(x + r, w - 1) + 1) if vc[c]]
        s = f(0.0)
        for k in rows:
            hs = f(0.0)
            for c in cols:
                hs = f(hs + v[b, k, c])
            s = f(s + hs)
        out[b, y, x] = s / max(f(len(rows)) * f(len(cols)), f(1.0))
    return out


@pytest.mark.parametrize("mask", ["corner", "rows", "all"])
@pytest.mark.parametrize("radius", [0, 2, 7])
def test_plain_masked_box_filter_sums_in_the_kernel_order(mask, radius):
    """The plain masked box filter, which the masked strips must equal bit
    for bit on the card, is the ascending per-pixel sum over the valid
    pixels bit for bit: +inf, -inf and NaN in the invalid rows and
    columns, -0.0 among the valid pixels, on a corner tile's mask (the
    first rows and last columns invalid), a row-only mask (no column
    validity) and an all-valid one; at r = 7 windows wider than the
    9 x 11 plane."""
    v = _maps(7, (2, 9, 11)) - 0.5
    v[0, 5, :] = -0.0
    vr, vc = np.ones(9, bool), np.ones(11, bool)
    if mask == "corner":
        vr[:3], vc[8:] = False, False
    elif mask == "rows":
        vr[[0, 4, 8]] = False
    specials = np.array([np.inf, -np.inf, np.nan], np.float32)
    v[:, ~vr, :] = specials[np.arange((~vr).sum()) % 3][None, :, None]
    v[:, :, ~vc] = specials[np.arange((~vc).sum()) % 3][None, None, :]
    tw = torch.from_numpy(vc) if mask == "corner" else None
    got = staged.plain_masked_box_filter(torch.from_numpy(v),
                                         torch.from_numpy(vr), radius,
                                         tw).numpy()
    want = _ascending_masked_box_filter(v, vr, vc, radius)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# Largest radius the window strips take: (kernel, dtype) -> r.
STRIP_LIMITS = [("box_filter", torch.float32, 175),
                ("box_filter", torch.bfloat16, 243),
                ("dark_channel", torch.float32, 265),
                ("dark_channel", torch.bfloat16, 265),
                ("min_filter", torch.float32, 175),
                ("min_filter", torch.bfloat16, 243),
                ("masked_box_filter", torch.float32, 170),
                ("masked_box_filter", torch.bfloat16, 236),
                ("masked_min_filter", torch.float32, 170),
                ("masked_min_filter", torch.bfloat16, 236)]


@pytest.mark.parametrize("kind,dtype,limit", STRIP_LIMITS)
def test_strips_fit_up_to_their_shared_memory(kind, dtype, limit):
    """The strips take a radius while a block of the tallest band fits its
    shared memory; past it the row window, which takes every radius the
    strips take at any height, so the strips narrow nothing. The serving
    radii (r = 7, gf_r = 20) and He et al.'s gf_r = 60 take the strips.
    The masked forms' counts and validity bytes take a little more than
    the unmasked strips' memory."""
    assert staged.strip_smem(limit, kind, dtype) <= staged.MAX_SMEM \
        < staged.strip_smem(limit + 1, kind, dtype)
    assert staged.strips_fit(kind, limit, dtype)
    assert not staged.strips_fit(kind, limit + 1, dtype)
    assert all(staged.strips_fit(kind, r, dtype) for r in (0, 7, 20, 60))
    for h in (1, 16, 481, 4096):
        staged._check_window(h, limit)
    if kind.startswith("masked_"):             # + the counts and the bytes
        cols, rows = staged.STRIP_W + 2 * limit, 128 + 2 * limit
        plain = staged.strip_smem(limit, kind[len("masked_"):], dtype)
        assert staged.strip_smem(limit, kind, dtype) - plain == 5 * (cols + rows) + 8


class _FakeLib:
    """A kernel library that records (entry point, argument ``arg``) and
    returns 0."""

    def __init__(self, calls, arg):
        self.calls, self.arg = calls, arg

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args[self.arg])) or 0


def _fake_launches(monkeypatch, arg):
    """Route the wrappers' launches to a :class:`_FakeLib`; returns its
    list of calls."""
    calls = []

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(staged, "_lib", lambda: _FakeLib(calls, arg))
    monkeypatch.setattr(staged, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    staged.reset_launches()
    return calls


def test_window_wrappers_pick_the_strips_or_the_row_window_by_shape(
        monkeypatch):
    """The dark channel, min filter and box filter wrappers launch the
    strips where :func:`staged.strips_fit` and the row window past it,
    chosen from the shape before the launch, and count both; the row
    window's launches also in ``wide_launches``."""
    calls = _fake_launches(monkeypatch, 5)
    for r in (0, 175, 176):
        staged.box_filter_op(_meta(2, 900, 8), r)
    staged.box_filter_op(_meta(2, 900, 8).bfloat16(), 244)
    for r in (265, 266):
        staged.dark_channel_op(_meta(2, 900, 8, 3), r)
    for r in (0, 7, 175, 176):
        staged.min_filter_op(_meta(2, 900, 8), r)
    staged.min_filter_op(_meta(2, 900, 8).bfloat16(), 243)
    staged.min_filter_op(_meta(2, 900, 8).bfloat16(), 244)
    assert calls == [("st_box_filter", 0), ("st_box_filter", 175),
                     ("st_box_filter_wide", 176), ("st_box_filter_wide", 244),
                     ("st_dark_channel", 265), ("st_dark_channel_wide", 266),
                     ("st_min_filter", 0), ("st_min_filter", 7),
                     ("st_min_filter", 175), ("st_min_filter_wide", 176),
                     ("st_min_filter", 243), ("st_min_filter_wide", 244)]
    assert staged.launches["box_filter"] == 4
    assert staged.launches["dark_channel"] == 2
    assert staged.launches["min_filter"] == 6
    assert staged.wide_launches == {"box_filter": 2, "dark_channel": 1,
                                    "min_filter": 2, "atmolight_topk": 0,
                                    "masked_min_filter": 0,
                                    "masked_box_filter": 0}
    staged.reset_launches()
    assert not any(staged.wide_launches.values())


@pytest.mark.parametrize("name", ["masked_min_filter", "masked_box_filter"])
def test_masked_wrappers_pick_the_strips_or_the_row_window_by_shape(
        name, monkeypatch):
    """The masked filters' wrappers launch the masked strips where
    :func:`staged.strips_fit` and the row window past it, chosen from the
    shape before the launch, and count both; the row window's launches
    also in ``wide_launches``."""
    calls = _fake_launches(monkeypatch, 7)
    op = getattr(staged, f"{name}_op")
    valid = torch.ones(900, dtype=torch.bool)
    limit = {torch.float32: 170, torch.bfloat16: 236}
    for dt, r in ((torch.float32, 0), (torch.float32, 20), (torch.float32, 170),
                  (torch.float32, 171), (torch.bfloat16, 236),
                  (torch.bfloat16, 237)):
        op(_meta(2, 900, 8).to(dt), valid, r, torch.ones(8, dtype=torch.bool))
        assert calls[-1] == (f"st_{name}" + ("_wide" if r > limit[dt] else ""), r)
    assert staged.launches[name] == 6 and staged.wide_launches[name] == 2
    assert sum(staged.launches.values()) == 6


@pytest.mark.parametrize("k,wide", [(1, False), (4, False),
                                    (staged.WARP_TOPK_MAX, False),
                                    (staged.WARP_TOPK_MAX + 1, True),
                                    (48 * 64, True)])
def test_atmolight_topk_picks_its_route_by_k(k, wide, monkeypatch):
    """The top-k light's wrapper launches the warp top-k for k up to
    ``WARP_TOPK_MAX`` and the block rounds past it, chosen from k before
    the launch, each with its own key lists' scratch, and counts both; the
    block rounds also in ``wide_launches``."""
    calls = _fake_launches(monkeypatch, 7)
    img, t = _meta(2, 48, 64, 3), _meta(2, 48, 64)
    made = []
    real_empty = torch.empty

    def empty(shape, **kw):               # the scratch and the output
        made.append(tuple(shape))
        return real_empty(shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    staged.atmolight_topk_op(img, t, k)
    entry = "st_atmolight_topk_wide" if wide else "st_atmolight_topk"
    assert calls == [(entry, k)]
    assert staged.warp_topk_fits(k) == (not wide)
    lists = ((2, 2, min(k, staged.TOPK_TILE)) if wide
             else (2, 1, k))                # 3072 px: 2 tiles of 2048, 1 of 4096
    assert made == [lists, (2, 3)]
    assert staged.launches["atmolight_topk"] == 1
    assert staged.wide_launches["atmolight_topk"] == int(wide)


def _ties_t_map(h, w):
    """Frame 0: negative values, its minimum at two indices; frame 1: all
    positive but for -0.0/+0.0 at several indices, -0.0 first."""
    t = np.stack([_maps(3, (h, w)) - 0.5, _maps(4, (h, w)) + 0.01])
    t[0].flat[[17, 5]] = -0.75
    t[1].flat[[40, 9, 23]] = [0.0, -0.0, 0.0]
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_map", ["ramp", "ties"])
def test_atmolight_matches_pallas(t_map, dtype):
    x = ramp_frames(5, 2, h=12, w=16)
    if t_map == "ramp":       # t_raw of the ramp itself: every level distinct
        t = 1.0 - 0.95 * x.min(-1)
    else:
        t = _ties_t_map(12, 16)
    jx, tx = wire(x, dtype)
    jt, tt = wire(t.astype(np.float32), dtype)
    got = staged.atmolight_op(tx, tt)
    want = atmolight_pallas(jx, jt, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(as_np(got), as_np(want))
    if t_map == "ties":
        flat = x.reshape(2, -1, 3)
        np.testing.assert_array_equal(as_np(got.float()),
                                      as_np(tx.float().reshape(2, -1, 3)[
                                          torch.arange(2), [5, 9]]))
        assert not np.array_equal(flat[1, 9], flat[1, 23])


def _top1_tile_pick(t: torch.Tensor) -> torch.Tensor:
    """B6a's two launches, emulated: each run of ``staged.TOP1_TILE``
    contiguous pixels reduced to its smallest (t, flat index) key (a tail
    run padded with the all-ones key), then each frame's smallest tile key;
    returns its flat index."""
    n = t.shape[0]
    keys = staged.topk_keys_signed(t)
    tiles = -(-keys.shape[1] // staged.TOP1_TILE)
    padded = torch.full((n, tiles * staged.TOP1_TILE), staged.KEY_LAST,
                        dtype=torch.int64)
    padded[:, :keys.shape[1]] = keys
    tile_keys = padded.reshape(n, tiles, staged.TOP1_TILE).amin(-1)
    return staged.key_index(tile_keys.amin(-1))


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("t_map", ["ramp", "ties"])
def test_atmolight_tile_keys_match_plain_and_pallas(t_map, dtype):
    """B6a's tile keys and merge (two tiles a frame, the second a tail)
    pick the pixel of the plain version and of the Pallas kernel: a ramp
    and an all-ties t; float32 and bfloat16 frames, and uint8 frames upcast
    to float32 as the staged chain feeds them."""
    h, w = 70, 61                      # 4270 pixels: one whole tile and a tail
    assert staged.TOP1_TILE < h * w < 2 * staged.TOP1_TILE
    x = ramp_frames(14, 2, h=h, w=w)
    if dtype == "uint8":
        x = (np.round(x * np.float32(255.0)) * np.float32(1 / 255.0)).astype(
            np.float32)
    t = (1.0 - 0.95 * x.min(-1) if t_map == "ramp"
         else np.full((2, h, w), 0.375, np.float32))
    wire_dt = "bfloat16" if dtype == "bfloat16" else "float32"
    (jx, tx), (jt, tt) = wire(x, wire_dt), wire(t.astype(np.float32), wire_dt)
    pick = _top1_tile_pick(tt)
    if t_map == "ties":
        assert not pick.any()
    got = tx.reshape(2, -1, 3)[torch.arange(2), pick]
    want_plain = staged.plain_atmolight(tx, tt)
    want_pallas = atmolight_pallas(jx, jt, interpret=True)
    np.testing.assert_array_equal(as_np(got), as_np(want_plain))
    np.testing.assert_array_equal(as_np(got), as_np(want_pallas))


@pytest.mark.parametrize("t_map", ["ramp", "constant"])
@pytest.mark.parametrize("k", [2, 4, 16, 17, "HW"])
def test_atmolight_topk_matches_pallas(k, t_map):
    """The plain version's picks are ``lax.top_k``'s bit for bit (ties, on
    the constant plane, to the lowest index) and its means the Pallas
    kernel's; k up to H*W, on both sides of the warp top-k's limit."""
    h, w = (4, 6) if k == "HW" else (12, 16)
    k = h * w if k == "HW" else k
    x = ramp_frames(12, 2, h=h, w=w)
    t = (1.0 - 0.95 * x.min(-1) if t_map == "ramp"
         else np.full((2, h, w), 0.375, np.float32))
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    picks = staged.key_index(staged.topk_select(tt, k))
    _, want_picks = jax.lax.top_k(-jnp.asarray(t).reshape(2, -1), k)
    np.testing.assert_array_equal(as_np(picks), np.asarray(want_picks))
    got = staged.atmolight_topk_op(tx, tt, k)
    want = atmolight_topk_pallas(jnp.asarray(x), jnp.asarray(t), k,
                                 interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-6, rtol=0)


def test_atmolight_topk_bfloat16_and_signed_zeros():
    """bfloat16 frames and t: the mean in float32 cast to bfloat16; DCP's
    negative t and -0.0/+0.0 ties keep the lowest indices first."""
    x = ramp_frames(13, 2, h=12, w=16)
    t = _ties_t_map(12, 16)
    (jx, tx), (jt, tt) = wire(x, "bfloat16"), wire(t.astype(np.float32),
                                                   "bfloat16")
    got = staged.atmolight_topk_op(tx, tt, 3)
    want = atmolight_topk_pallas(jx, jt, 3, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got), as_np(want))
    picks = as_np(staged.key_index(staged.topk_select(tt, 3)))
    np.testing.assert_array_equal(picks[0][:2], [5, 17])
    np.testing.assert_array_equal(picks[1], [9, 23, 40])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [1.0, 1 / 2.2])
def test_recover_matches_pallas(gamma, dtype):
    x = _maps(6, (2, 12, 16, 3))
    t = _maps(7, (2, 12, 16)) * 0.9          # some pixels below t0
    a = 0.7 + 0.3 * _maps(8, (2, 3))
    (jx, tx), (jt, tt), (ja, ta) = (wire(v, dtype) for v in (x, t, a))
    got = staged.recover_op(tx, tt, ta, 0.1, gamma)
    want = recover_pallas(jx, jt, ja, t0=0.1, gamma=gamma, interpret=True)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                               atol=_tol(dtype, 1e-6))


@pytest.mark.parametrize("radius", [2, 6])
def test_guided_filter_matches_pallas(radius):
    g, p = _maps(9, (2, 32, 24)), _maps(10, (2, 32, 24))
    got = tops.guided_filter(torch.from_numpy(g), torch.from_numpy(p), radius,
                             1e-3, mode="pallas")
    want = jops.guided_filter(jnp.asarray(g), jnp.asarray(p), radius, 1e-3,
                              mode="interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-4)


# --- the staged steps against the JAX staged steps --------------------------

def _compare_step(got, want, dtype):
    tol = _tol(dtype, 2e-4)
    for g, w in ((got.frames, want.frames),
                 (got.transmission, want.transmission)):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol, rtol=0)
    np.testing.assert_allclose(as_np(got.atmo_light), as_np(want.atmo_light),
                               atol=_tol(dtype, 1e-5), rtol=0)
    np.testing.assert_allclose(as_np(got.state.A), as_np(want.state.A),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(as_np(got.state.last_update),
                                  as_np(want.state.last_update))
    np.testing.assert_array_equal(as_np(got.state.initialized),
                                  as_np(want.state.initialized))


@pytest.mark.parametrize("mode,dtype", [("pallas", "float32"),
                                        ("auto", "uint8"),
                                        ("pallas", "bfloat16")])
def test_staged_lane_step_matches_jax(mode, dtype, monkeypatch):
    """Two chained batches over 3 lanes (the last all padding): each
    component runs once a step over all lanes (the guided filter's box
    filter six times), each lane's saved A feeds its own pre-divide, and
    every live lane equals the single-stream step."""
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
    calls = dict.fromkeys(staged.KERNELS, 0)
    for name in staged.KERNELS:
        def counted(*a, _name=name, _op=getattr(staged, f"{name}_op")):
            calls[_name] += 1
            return _op(*a)
        monkeypatch.setattr(staged, f"{name}_op", counted)
    L, B, H, W = 3, 2, 12, 16
    x = ramp_frames(20, 2, L, B, h=H, w=W)
    jstep = jax_multi_step(JaxConfig(kernel_mode="interpret", io_dtype=dtype,
                                     **STEP_CFG))
    cfg = DehazeConfig(kernel_mode=mode, io_dtype=dtype, **STEP_CFG)
    step = make_multi_stream_step(cfg, device="cpu")
    jstate, state = jax_init_lanes(L), init_atmo_state_lanes(L)
    staged.reset_launches()
    for batch in range(2):
        jx, tx = wire(x[batch], dtype)
        ids = np.tile(np.arange(B * batch, B * (batch + 1), dtype=np.int32),
                      (L, 1))
        ids[L - 1] = -1
        want = jstep(jx, jnp.asarray(ids), jstate)
        got = step(tx, torch.from_numpy(ids), state)
        _compare_step(got, want, dtype)
        assert torch.equal(got.state.A[L - 1], state.A[L - 1])
        assert not bool(got.state.initialized[L - 1])
        jstate, state = want.state, got.state
    assert calls == {"dark_channel": 2, "min_filter": 0, "box_filter": 12,
                     "atmolight": 2, "atmolight_topk": 0, "recover": 2}
    assert not any(staged.launches.values())     # CPU: plain versions only
    single = make_dehaze_step(cfg, device="cpu")
    one = init_atmo_state()
    for batch in range(2):
        _, tx = wire(x[batch], dtype)
        out = single(tx[0], torch.arange(B * batch, B * (batch + 1),
                                         dtype=torch.int32), one)
        one = out.state
    np.testing.assert_allclose(as_np(out.frames), as_np(got.frames[0]),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("algorithm,topk,dtype", [("cap", 1, "uint8"),
                                                  ("cap", 4, "float32"),
                                                  ("dcp", 4, "bfloat16")])
def test_staged_cap_and_topk_lane_steps_match_jax(algorithm, topk, dtype,
                                                  monkeypatch):
    """Staged CAP (the min filter) and staged top-k: two chained batches
    over 3 lanes (the last all padding) against the JAX interpret step; the
    min filter replaces the dark channel, the top-k the argmin light."""
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
    calls = dict.fromkeys(staged.KERNELS, 0)
    for name in staged.KERNELS:
        def counted(*a, _name=name, _op=getattr(staged, f"{name}_op")):
            calls[_name] += 1
            return _op(*a)
        monkeypatch.setattr(staged, f"{name}_op", counted)
    L, B, H, W = 3, 2, 12, 16
    kw = dict(STEP_CFG, algorithm=algorithm, topk=topk, io_dtype=dtype)
    x = ramp_frames(23, 2, L, B, h=H, w=W)
    jstep = jax_multi_step(JaxConfig(kernel_mode="interpret", **kw))
    step = make_multi_stream_step(DehazeConfig(kernel_mode="pallas", **kw),
                                  device="cpu")
    jstate, state = jax_init_lanes(L), init_atmo_state_lanes(L)
    for batch in range(2):
        jx, tx = wire(x[batch], dtype)
        ids = np.tile(np.arange(B * batch, B * (batch + 1), dtype=np.int32),
                      (L, 1))
        ids[L - 1] = -1
        want = jstep(jx, jnp.asarray(ids), jstate)
        got = step(tx, torch.from_numpy(ids), state)
        _compare_step(got, want, dtype)
        jstate, state = want.state, got.state
    cap, topk1 = algorithm == "cap", topk == 1
    assert calls == {"dark_channel": 0 if cap else 2, "min_filter": 2 if cap else 0,
                     "box_filter": 12, "atmolight": 2 if topk1 else 0,
                     "atmolight_topk": 0 if topk1 else 2, "recover": 2}


def test_staged_fallback_under_fused_matches_jax(monkeypatch):
    """DCP with ``recompute_t_with_final_a`` under ``"fused"``: the config
    the megakernel does not cover runs the staged chain on both sides."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")    # the JAX side
    kw = dict(STEP_CFG, kernel_mode="fused", recompute_t_with_final_a=True)
    x = ramp_frames(21, 4, h=12, w=16)
    ids = np.arange(4, dtype=np.int32)
    want = jax_single_step(JaxConfig(**kw))(jnp.asarray(x), jnp.asarray(ids),
                                            jax_init())
    got = make_dehaze_step(DehazeConfig(**kw), device="cpu")(
        torch.from_numpy(x), torch.from_numpy(ids), init_atmo_state())
    _compare_step(got, want, "float32")


def test_jax_state_seeds_the_staged_server():
    """A JAX server's store (the EMA ``AtmoState`` and cursors) seeds the
    port's staged server (default ``kernel_mode``); the second half of each
    stream matches a JAX server finishing from the same store."""
    rng = np.random.default_rng(22)
    vids = [[rng.random((12, 16, 3)).astype(np.float32) for _ in range(n)]
            for n in (6, 5)]
    cfg_j = JaxConfig(kernel_mode="ref", **STEP_CFG)
    first = JaxServer(cfg_j, batch=2, timeout_s=5.0)
    first.serve_many([JaxRequest(f"s{i}", iter(v[:3]))
                      for i, v in enumerate(vids)])
    tree = first.store.to_pytree()
    jsrv = JaxServer(cfg_j, batch=2, timeout_s=5.0)
    jsrv.store = type(first.store).from_pytree(tree)
    jouts = {}
    jsrv.serve_many([JaxRequest(f"s{i}", iter(v[3:]))
                     for i, v in enumerate(vids)],
                    sink=lambda sid, fid, f: jouts.setdefault((sid, fid), f))
    srv = ElasticServer(DehazeConfig(**STEP_CFG), batch=2, timeout_s=5.0,
                        device="cpu")
    srv.store = StreamStateStore.from_jax_pytree(tree)
    outs = {}
    rep = srv.serve_many([StreamRequest(f"s{i}", iter(v[3:]))
                          for i, v in enumerate(vids)],
                         sink=lambda sid, fid, f: outs.setdefault((sid, fid), f))
    assert rep.skipped == 0 and set(outs) == set(jouts)
    for key, f in jouts.items():
        np.testing.assert_allclose(as_np(outs[key]), as_np(f), atol=2e-4,
                                   rtol=0)
    for sid in ("s0", "s1"):
        assert srv.store.cursor(sid) == jsrv.store.cursor(sid)
        np.testing.assert_allclose(as_np(srv.store.get(sid).A),
                                   as_np(jsrv.store.get(sid).A), atol=1e-5)


# --- contracts: what is not ported raises, nothing falls back ---------------

def _meta(*shape):
    """A tensor off the CPU: the ops send it to the kernel path."""
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("mode", ["auto", "pallas", "fused"])
def test_staged_min_filter_and_topk_reach_the_kernels_off_the_cpu(
        mode, monkeypatch):
    """Off the CPU, staged CAP's min filter and the top-k light go to their
    CUDA wrappers (which refuse a tensor that is not on a CUDA device),
    never to a plain version."""
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")
    for name in ("min_filter", "atmolight_topk"):
        monkeypatch.setattr(staged, f"plain_{name}", plain)
    before = counter_snapshot()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tops.min_filter_2d(_meta(2, 8, 8), 1, mode=mode)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tops.atmospheric_light(_meta(2, 8, 8, 3), _meta(2, 8, 8), k=4,
                               mode=mode)
    assert counter_snapshot() == before      # this test launched nothing


def test_failed_staged_build_raises_instead_of_the_plain_version(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(staged, "_lib_handle", None)
    monkeypatch.setattr(staged, "_check_cuda", lambda *t: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a device tensor")
    for name in staged.KERNELS:
        monkeypatch.setattr(staged, f"plain_{name}", plain)
    before = counter_snapshot()
    with pytest.raises(RuntimeError, match="nvcc"):
        staged.dark_channel_op(_meta(2, 8, 8, 3), 1)
    with pytest.raises(RuntimeError, match="nvcc"):
        tops.box_filter_2d(_meta(2, 8, 8), 1, mode="pallas")
    assert counter_snapshot() == before      # this test launched nothing


def test_cuda_wrappers_refuse_cpu_tensors_and_other_dtypes():
    x = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        staged.cuda_dark_channel(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        staged.cuda_recover(x, x[..., 0], torch.ones(1, 3))
    for bad in (x.double(), (x * 255).to(torch.uint8)):
        with pytest.raises(ValueError, match="dtype"):
            staged.plain_dark_channel(bad, 1)
        with pytest.raises(ValueError, match="dtype"):
            staged.plain_atmolight(bad, x[..., 0])
    with pytest.raises(ValueError, match="N, H, W"):
        staged.plain_box_filter(x, 1)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = torch.from_numpy(ramp_frames(30, 4, h=48, w=64)).cuda()
    t = torch.from_numpy(_maps(31, (4, 48, 64))).cuda()
    a = torch.full((4, 3), 0.8, device="cuda")
    cases = {"dark_channel": (x, 7), "min_filter": (t, 7), "box_filter": (t, 20),
             "atmolight": (x, t), "atmolight_topk": (x, t, 4),
             "recover": (x, t, a)}
    assert set(cases) == set(staged.KERNELS)
    for name, args in cases.items():
        kernel, plain = staged.PAIRS[name]
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        tol = {"recover": 1e-5, "atmolight_topk": 1e-6}.get(name, 0.0)
        assert float((got - want).abs().max()) <= tol, name
    # The window strips (B3a, B3b, B4), bit-equal to their plain versions,
    # and the row window past their radius, chosen by shape: tails, r = 0,
    # a window wider than the frame, a batch off a 16-byte boundary, both
    # sides of the strips' limit.
    for dt in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(_maps(34, (5, 70, 61)) - 0.5).to(dt).cuda()
        fx = torch.from_numpy(ramp_frames(35, 5, h=70, w=61)).to(dt).cuda()
        for name, v in (("box_filter", tx), ("dark_channel", fx),
                        ("min_filter", tx)):
            limit = {(kind, t): r for kind, t, r in STRIP_LIMITS}[name, dt]
            for arg, r in ((v, 7), (v, 0), (v, 40), (v[1:], 3), (v, limit),
                           (v, limit + 1)):
                staged.reset_launches()
                got = staged.PAIRS[name][0](arg, r)
                torch.cuda.synchronize()
                assert staged.wide_launches[name] == int(r > limit), (name, r)
                want = staged.PAIRS[name][1](arg, r)
                assert float((got.float() - want.float()).abs().max()) == 0.0, \
                    (name, dt, r)
    # B6a: whole tiles and a tail, twice in a row, bit-equal.
    for shape in ((4, 48, 64), (2, 70, 61), (1, 7, 5)):
        xs = torch.from_numpy(ramp_frames(32, shape[0], h=shape[1],
                                          w=shape[2])).cuda()
        ts = torch.from_numpy(_maps(33, shape)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            first = staged.cuda_atmolight(xs.to(dt), ts.to(dt))
            second = staged.cuda_atmolight(xs.to(dt), ts.to(dt))
            torch.cuda.synchronize()
            want = staged.plain_atmolight(xs.to(dt), ts.to(dt))
            assert torch.equal(first, want) and torch.equal(second, want), shape
    # k above one tile's pixels, up to H*W: the merge exhausts tile lists.
    for k in (staged.TOPK_TILE + 1, 48 * 64):
        got = staged.cuda_atmolight_topk(x, t, k)
        torch.cuda.synchronize()
        want = staged.plain_atmolight_topk(x, t, k)
        assert float((got - want).abs().max()) <= 1e-6, k
    # The warp top-k on both sides of its limit, bit-equal to the block
    # rounds, on a frame whose pixels are not a whole number of tiles.
    xs = torch.from_numpy(ramp_frames(36, 3, h=70, w=61)).cuda()
    ts = torch.from_numpy(_maps(37, (3, 70, 61))).cuda()
    for k in (2, 4, staged.WARP_TOPK_MAX, staged.WARP_TOPK_MAX + 1):
        staged.reset_launches()
        got = staged.cuda_atmolight_topk(xs, ts, k)
        torch.cuda.synchronize()
        assert staged.wide_launches["atmolight_topk"] == int(k > staged.WARP_TOPK_MAX)
        assert torch.equal(got, staged._atmolight_topk(xs, ts, k, wide=True)), k
        want = staged.plain_atmolight_topk(xs, ts, k)
        assert float((got - want).abs().max()) <= 1e-6, k
    # The staged lane step on device-resident frames never synchronises.
    step = make_multi_stream_step(DehazeConfig(), device="cuda")
    ids = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    state = init_atmo_state_lanes(2, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(x.reshape(2, 2, 48, 64, 3), ids, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
