"""PyTorch port, the fused megakernel: ``repro_torch.kernels.ops`` /
``kernels.fused`` against the JAX package's ``kernels.ops`` on the same
numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernels are held
against that plain version on the card (``chip_smoke.py``, and the
``cuda``-marked test below). Here the cells check the plain version and
the pass decompositions the card runs (``fused.run_tiled_passes``, the
megakernel, and ``fused.run_passes``, the ten passes it replaced, through
the plain passes) against the reference, at the reference's own tolerances
(``tests/test_fused.py``): J/t 1e-4 with refine and 1e-5 without, a_seq
and the final A 1e-5, last_update/initialized exact, bfloat16 2e-2. The
fused transmission stage of the sharded step (its tiled sequence and its
ten passes, through the plain passes, equal to each other) is held to the
Pallas kernels in interpret mode: t 1e-4, t_min and the candidates 1e-5.
Which sequence the stage and its halo form run is decided from the shape;
a fake library shows the launches on both sides of each limit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.fused import (fused_transmission_lanes_pallas,
                                 fused_transmission_pallas)
from repro_torch.kernels import _build, fused, staged
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_common import as_np, ramp_frames, wire
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

L, B, H, W = 3, 2, 16, 20
KW = dict(radius=3, omega=0.95, beta=1.2, gf_radius=4, gf_eps=1e-3, t0=0.1,
          gamma=1.0, period=2, lam=0.3)


def _carry():
    cf = np.ones((L, 3), np.float32)
    cf[1] = [0.7, 0.75, 0.8]                      # a warm lane
    ci = np.tile(np.asarray([-(2 ** 30), 0], np.int32), (L, 1))
    ci[1] = [5, 1]
    return cf, ci


def _ids(start):
    ids = np.tile(np.arange(start, start + B, dtype=np.int32), (L, 1))
    ids[2] = -1                                   # an all-padding lane
    return ids


def _compare(got, want, refine, dtype):
    tol = 2e-2 if dtype == "bfloat16" else (1e-4 if refine else 1e-5)
    for g, w in zip(got[:2], want[:2]):                     # J, t
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol, rtol=0)
    tol_a = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(as_np(got[2]), as_np(want[2]), atol=tol_a)
    np.testing.assert_allclose(as_np(got[3]), as_np(want[3]), atol=tol_a)
    np.testing.assert_array_equal(as_np(got[4]), as_np(want[4]))


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("topk", [1, 4])
@pytest.mark.parametrize("algorithm", ["dcp", "cap"])
@pytest.mark.parametrize("refine", [False, True])
def test_fused_lanes_matches_reference(algorithm, topk, dtype, refine):
    """Two chained batches, one all-padding lane, one warm lane."""
    x = ramp_frames(11, 2, L, B, h=H, w=W)
    kw = dict(KW, algorithm=algorithm, topk=topk, refine=refine)
    cf, ci = _carry()
    jcarry = (jnp.asarray(cf), jnp.asarray(ci))
    tcarry = (torch.from_numpy(cf), torch.from_numpy(ci))
    for batch in range(2):
        jx, tx = wire(x[batch], dtype)
        ids = _ids(10 + B * batch)
        want = jops.fused_dehaze_lanes(jx, jnp.asarray(ids), *jcarry,
                                       mode="ref", **kw)
        got = tops.fused_dehaze_lanes(tx, torch.from_numpy(ids), *tcarry,
                                      mode="fused", **kw)
        assert got[0].dtype == tref.resolve_out_dtype(dtype)
        _compare(got, want, refine, dtype)
        # The padding lane's carry rides through bit-unchanged.
        assert torch.equal(got[3][2], tcarry[0][2])
        assert torch.equal(got[4][2], tcarry[1][2])
        jcarry, tcarry = want[3:], got[3:]


@pytest.mark.parametrize("algorithm,topk,dtype,refine",
                         [("dcp", 1, "float32", True),
                          ("cap", 4, "uint8", True),
                          ("dcp", 4, "bfloat16", False)])
def test_pass_decomposition_matches_plain_version(algorithm, topk, dtype,
                                                  refine):
    """The card's pass sequence, run through the plain passes, equals the
    plain version of the whole megakernel."""
    x = ramp_frames(12, L, B, h=H, w=W)
    _, tx = wire(x, dtype)
    kw = dict(KW, algorithm=algorithm, topk=topk, refine=refine)
    cf, ci = (torch.from_numpy(a) for a in _carry())
    ids = torch.from_numpy(_ids(0))
    s = fused.make_static(tx, **kw)
    got = fused.run_passes(tx, ids, cf, ci, s, fused.PLAIN_PASSES)
    want = tref.fused_dehaze_lanes(tx, ids, cf, ci, **kw)
    tol = 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol, rtol=0)


@pytest.mark.parametrize("algorithm,topk,dtype,refine",
                         [("dcp", 1, "float32", True),
                          ("cap", 4, "uint8", True),
                          ("dcp", 4, "bfloat16", False)])
def test_tiled_passes_match_ten_passes_and_reference(algorithm, topk, dtype,
                                                     refine):
    """The megakernel's tiled pass sequence, run through the plain passes,
    equals the ten-pass sequence exactly, the plain version of the whole
    within 1e-5, and the JAX reference at its own tolerances."""
    x = ramp_frames(12, L, B, h=H, w=W)
    jx, tx = wire(x, dtype)
    kw = dict(KW, algorithm=algorithm, topk=topk, refine=refine)
    cf, ci = _carry()
    ids = _ids(0)
    s = fused.make_static(tx, **kw)
    targs = (tx, torch.from_numpy(ids), torch.from_numpy(cf),
             torch.from_numpy(ci))
    got = fused.run_tiled_passes(*targs, s, fused.PLAIN_PASSES)
    ten = fused.run_passes(*targs, s, fused.PLAIN_PASSES)
    for g, t in zip(got, ten):
        assert torch.equal(g, t)
    for g, w in zip(got, tref.fused_dehaze_lanes(*targs, **kw)):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5, rtol=0)
    want = jops.fused_dehaze_lanes(jx, jnp.asarray(ids), jnp.asarray(cf),
                                   jnp.asarray(ci), mode="ref", **kw)
    _compare(got, want, refine, dtype)


@pytest.mark.parametrize("dtype,radius,gf_radius",
                         [("uint8", 7, 60), ("float32", 37, 4),
                          ("bfloat16", 3, 46)])
def test_wide_windows_match_reference(dtype, radius, gf_radius):
    """Windows whose halo does not fit a tiled pass's block (He et al.'s
    gf_r = 60 among them), which the card runs through the ten passes:
    their plain sequence matches the plain version of the whole and the JAX
    reference at the reference's tolerances."""
    x = ramp_frames(19, L, B, h=H, w=W)
    jx, tx = wire(x, dtype)
    kw = dict(KW, radius=radius, gf_radius=gf_radius, refine=True)
    cf, ci = _carry()
    ids = _ids(0)
    s = fused.make_static(tx, **kw)
    targs = (tx, torch.from_numpy(ids), torch.from_numpy(cf),
             torch.from_numpy(ci))
    got = fused.run_passes(*targs, s, fused.PLAIN_PASSES)
    _compare(got, tref.fused_dehaze_lanes(*targs, **kw), True, dtype)
    want = jops.fused_dehaze_lanes(jx, jnp.asarray(ids), jnp.asarray(cf),
                                   jnp.asarray(ci), mode="ref", **kw)
    _compare(got, want, True, dtype)


def _first_tile_with_min(keys: torch.Tensor) -> torch.Tensor:
    """The merge a tile order would give: the smallest t, ties to the
    first tile holding it (what comparing whole keys must not do)."""
    t = staged.key_t(staged.flip_key_order(keys))
    first = (t == t.amin(-1, keepdim=True)).to(torch.int8).argmax(-1)
    return staged.key_index(staged.flip_key_order(
        keys[torch.arange(keys.shape[0]), first]))


def test_tile2d_top1_keys_pick_reference_pixel_on_plateau():
    """``tmap_tile``'s 2-D tile keys (``fused.tile2d_keys``) and their
    merge pick ``lax.top_k``'s pixel where the smallest t ties across tiles
    (t_raw of quantised frames, and a plane whose lowest tied index is in
    the second tile, while the first tile also holds the minimum); the
    candidate is the reference's."""
    h, w = fused.TILE_H + 8, fused.TILE_W + 6            # 2 x 2 tiles, tails
    q = np.round(np.random.default_rng(22).random((2, 1, h, w, 3)) * 4) / 4
    x = torch.from_numpy((q * 0.8 + 0.1).astype(np.float32))
    kw = dict(KW, algorithm="dcp", topk=1, refine=False)
    s = fused.make_static(x, **kw)
    t_raw, _, keys = fused.plain_tmap_tile(x, torch.ones(2, 3), s)
    assert keys.shape == (2, 4)
    tied = []
    for n in range(2):
        ys, xs = np.nonzero(as_np(t_raw[n]) == float(t_raw[n].min()))
        tied.append(len({(y // fused.TILE_H, c // fused.TILE_W)
                         for y, c in zip(ys, xs)}))
    assert min(tied) >= 2                        # the ties span tiles
    plane = np.full((1, h, w), 0.5, np.float32)
    plane[0, 5, 3] = plane[0, 0, fused.TILE_W] = 0.25   # tile 0, then tile 1
    for t in (t_raw, torch.from_numpy(plane)):
        k2d = fused.tile2d_keys(t)
        picked = staged.key_index(torch.sort(staged.flip_key_order(k2d),
                                             dim=-1).values[:, 0])
        _, want = jax.lax.top_k(-jnp.asarray(as_np(t)).reshape(len(t), -1), 1)
        np.testing.assert_array_equal(as_np(picked), np.asarray(want)[:, 0])
    assert int(picked[0]) == fused.TILE_W                # not (5, 3)
    assert int(_first_tile_with_min(k2d)[0]) == 5 * w + 3
    cand = fused.plain_topk_merge(keys, x, s)
    want = jops.fused_dehaze_lanes(            # two lanes of one frame: a_seq
        jnp.asarray(as_np(x)), jnp.zeros((2, 1), jnp.int32),   # bootstraps to
        jnp.ones((2, 3)), jnp.asarray([[-(2 ** 30), 0]] * 2, jnp.int32),
        mode="ref", **kw)[2]                                   # the candidate
    np.testing.assert_allclose(as_np(cand), np.asarray(want).reshape(2, 3),
                               atol=1e-6)


@pytest.mark.parametrize("a_saved", [1.0, 0.01])
@pytest.mark.parametrize("topk", [1, 5])
def test_topk_keys_select_reference_pixels(topk, a_saved):
    """The kernel's (t, index) keys, decoded by the plain passes, pick
    exactly the reference's ``lax.top_k`` pixels, also for the negative
    t_raw a small saved A gives (I/A > 1/omega)."""
    x = ramp_frames(13, 1, B, h=40, w=60)[0]
    kw = dict(KW, algorithm="dcp", topk=topk, refine=False)
    tx = torch.from_numpy(x)[None]
    s = fused.make_static(tx, **kw)
    cf = torch.full((1, 3), a_saved)
    pre, _ = fused.plain_premap(tx, cf, s)
    t_raw = fused.plain_min_cols_tmap(fused.plain_min_rows(pre, s), s)
    if a_saved < 1.0:
        assert float(t_raw.min()) < 0.0
    keys = fused.plain_topk_block(t_raw, s)
    assert keys.shape[1] == -(-(40 * 60) // fused.TILE_PIXELS)
    best = torch.sort(staged.flip_key_order(keys.reshape(B, -1))
                      ).values[:, :topk]
    picked = staged.key_index(best)
    _, want = jax.lax.top_k(-jnp.asarray(as_np(t_raw)).reshape(B, -1), topk)
    np.testing.assert_array_equal(as_np(picked), np.asarray(want))


def test_interpret_kernel_cell():
    """One small cell against the Pallas kernel body itself."""
    x = ramp_frames(14, 2, 2, h=12, w=16)
    kw = dict(KW, algorithm="dcp", topk=1, refine=True, radius=2,
              gf_radius=3)
    cf = np.ones((2, 3), np.float32)
    ci = np.tile(np.asarray([-(2 ** 30), 0], np.int32), (2, 1))
    ids = np.asarray([[0, 1], [-1, -1]], np.int32)
    want = jops.fused_dehaze_lanes(jnp.asarray(x), jnp.asarray(ids),
                                   jnp.asarray(cf), jnp.asarray(ci),
                                   mode="interpret", **kw)
    got = tops.fused_dehaze_lanes(torch.from_numpy(x), torch.from_numpy(ids),
                                  torch.from_numpy(cf), torch.from_numpy(ci),
                                  mode="fused", **kw)
    _compare(got, want, True, "float32")


def test_single_stream_is_the_l1_view():
    x = ramp_frames(15, B, h=H, w=W)
    kw = dict(KW, algorithm="cap", topk=1, refine=True)
    ids = torch.arange(B, dtype=torch.int32)
    got = tops.fused_dehaze(torch.from_numpy(x), ids, torch.ones(3),
                            torch.tensor(-(2 ** 30), dtype=torch.int32),
                            torch.tensor(False), mode="fused", **kw)
    want = jops.fused_dehaze(jnp.asarray(x), jnp.asarray(ids.numpy()),
                             jnp.ones(3), jnp.asarray(-(2 ** 30), jnp.int32),
                             jnp.asarray(False), mode="ref", **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-4)


# --- the fused transmission stage (the sharded step's) ------------------------

TKW = dict(radius=2, omega=0.95, beta=1.2, gf_radius=3, gf_eps=1e-3)


def _compare_transmission(got, want):
    """(t, t_min, cand): t 1e-4, t_min and the candidates 1e-5."""
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(as_np(g), as_np(w), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("topk", [1, 4])
@pytest.mark.parametrize("algorithm", ["dcp", "cap"])
def test_transmission_passes_match_pallas(algorithm, topk, dtype):
    """The lane form (per-lane A: frame row i reads lane i // B's), its
    tiled sequence and its ten passes through the plain passes, equal to
    each other and each against ``fused_transmission_lanes_pallas``; its
    L=1 view through ``ops`` against ``fused_transmission_pallas``."""
    x = ramp_frames(19, 2, 3, h=12, w=16)
    a = np.array([[0.9, 0.8, 0.85], [0.6, 0.7, 0.65]], np.float32)
    jx, tx = wire(x, dtype)
    kw = dict(TKW, algorithm=algorithm, topk=topk, refine=True)
    s = fused.make_static(tx, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
    got = fused.run_transmission_passes(tx, torch.from_numpy(a), s,
                                        fused.TRANSMISSION_PLAIN_PASSES)
    tiled = fused.run_tiled_transmission_passes(
        tx, torch.from_numpy(a), s, fused.TILED_TRANSMISSION_PLAIN_PASSES)
    for g, t in zip(tiled, got):
        assert torch.equal(g, t)
    want = fused_transmission_lanes_pallas(jx, jnp.asarray(a),
                                           interpret=True, **kw)
    _compare_transmission(got, want)
    _compare_transmission(tiled, want)
    got = tops.fused_transmission(tx[1], torch.from_numpy(a[1]),
                                  mode="fused", **kw)
    want = fused_transmission_pallas(jx[1], jnp.asarray(a[1]),
                                     interpret=True, **kw)
    _compare_transmission(got, want)


@pytest.mark.parametrize("refine", [False, True])
def test_transmission_stage_is_the_megakernel_up_to_the_ema(refine):
    """t of the stage is the megakernel's t, its candidates the
    megakernel's merge of the same keys (cast to the output dtype), and
    t_min the smallest t_raw: pass for pass on the plain passes."""
    x = torch.from_numpy(ramp_frames(20, L, B, h=H, w=W))
    cf, ci = (torch.from_numpy(c) for c in _carry())
    kw = dict(KW, algorithm="dcp", topk=3, refine=refine)
    s = fused.make_static(x, **kw)
    t, t_min, cand = fused.run_transmission_passes(
        x, cf, s, fused.TRANSMISSION_PLAIN_PASSES)
    _, b1_t, *_ = fused.run_passes(x, torch.from_numpy(_ids(0)), cf, ci, s,
                                   fused.PLAIN_PASSES)
    assert torch.equal(t, b1_t)
    pre, _ = fused.plain_premap(x, cf, s)
    t_raw = fused.plain_min_cols_tmap(fused.plain_min_rows(pre, s), s)
    keys = fused.plain_topk_block(t_raw, s)
    assert torch.equal(cand.reshape(-1, 3), fused.plain_topk_merge(keys, x, s))
    assert torch.equal(t_min.reshape(-1), t_raw.reshape(L * B, -1).amin(-1))


def test_cpu_transmission_wrapper_launches_no_kernel():
    x = torch.from_numpy(ramp_frames(21, L, B, h=H, w=W))
    fused.reset_launches()
    fused.fused_transmission_lanes(x, torch.ones(L, 3), refine=True, **TKW)
    assert set(fused.transmission_launches) == set(
        fused.TILED_TRANSMISSION_PASSES + fused.TRANSMISSION_PASSES)
    assert not any(fused.transmission_launches.values())
    assert not any(fused.launches.values())
    with pytest.raises(ValueError, match=r"\(L, 3\)"):
        fused.fused_transmission_lanes(x, torch.ones(3), refine=True, **TKW)


# Both sides of each limit of the transmission stage's and the halo form's
# tiled sequences: (form, frame dtype, radius, gf_radius, refine, the tiles
# fit).
ROUTE_LIMITS = [
    ("transmission", torch.float32, 36, 20, True, True),
    ("transmission", torch.float32, 37, 20, True, False),
    ("transmission", torch.bfloat16, 52, 20, True, True),
    ("transmission", torch.bfloat16, 53, 20, True, False),
    ("transmission", torch.uint8, 66, 20, True, True),
    ("transmission", torch.uint8, 67, 20, True, False),
    ("transmission", torch.uint8, 7, 45, True, True),
    ("transmission", torch.uint8, 7, 46, True, False),
    ("transmission", torch.uint8, 7, 46, False, True),   # no guided filter
    ("halo", torch.float32, 88, 20, True, True),
    ("halo", torch.float32, 89, 20, True, False),
    ("halo", torch.uint8, 7, 45, True, True),
    ("halo", torch.uint8, 7, 46, True, False),
]


@pytest.mark.parametrize("form,dtype,radius,gf_radius,refine,fits",
                         ROUTE_LIMITS)
def test_transmission_stages_pick_tiles_or_ten_passes_by_shape(
        form, dtype, radius, gf_radius, refine, fits, monkeypatch):
    """The transmission stage and its halo form launch their tiled sequence
    where every block fits its shared memory
    (:func:`fused.transmission_tiled_fits`, :func:`fused.halo_tiled_fits`,
    the CUDA source's arithmetic, which ``chip_smoke.py`` holds against the
    library) and the ten passes past it, chosen from the shape before any
    launch, and count the launches under the passes' names."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(fused, "_lib", lambda: Lib())
    monkeypatch.setattr(fused, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    fused.reset_launches()
    kw = dict(radius=radius, refine=refine, gf_radius=gf_radius, gf_eps=1e-3,
              topk=4)
    if form == "transmission":
        img = torch.empty((2, 3, 48, 80, 3), dtype=dtype, device="meta")
        s = fused.make_static(img, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
        assert fused.transmission_tiled_fits(s) == fits
        fused.run_transmission(img, torch.empty((2, 3), device="meta"), s)
        counts, prefix = fused.transmission_launches, "fd_"
        route = (fused.TILED_TRANSMISSION_PASSES if fits
                 else fused.TRANSMISSION_PASSES)
    else:
        halo = radius + 2 * gf_radius
        img = torch.empty((2, 24, 30, 3), dtype=dtype, device="meta")
        plane = torch.empty((2, 24 + 2 * halo, 30 + 2 * halo), device="meta")
        s = fused.make_halo_static(img, plane, plane, **kw)
        assert fused.halo_tiled_fits(s) == fits
        v = [torch.empty(n, dtype=torch.uint8, device="meta")
             for n in (s.h_ext, s.w_ext)]
        fused.run_halo(img, plane, plane, *v, s)
        counts, prefix = fused.halo_launches, "fd_halo_"
        route = fused.TILED_HALO_PASSES if fits else fused.HALO_PASSES
    ran = [p for p in route if refine or p not in (
        "guided_ab", "box_rows4", "box_cols_ab", "box_rows2")]
    kernel = {"candidate": "topk_merge"}
    assert calls == [prefix + kernel.get(p, p) for p in ran]
    assert {p: n for p, n in counts.items() if n} == dict.fromkeys(ran, 1)


# --- contracts: dispatch, no fallback ----------------------------------------

def test_mode_resolution(monkeypatch):
    """``auto`` resolves as the reference does on an accelerator: the
    substrate ``REPRO_KERNEL_MODE`` names, else the staged kernels."""
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
    assert tops.resolve_mode("ref") == "ref"
    assert tops.resolve_mode("fused") == "fused"
    for m in ("pallas", "auto"):
        assert tops.resolve_mode(m) == "pallas"
    with pytest.raises(ValueError):
        tops.resolve_mode("interpret")
    with pytest.raises(ValueError):
        tops.resolve_mode("Pallas")
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    assert tops.resolve_mode("auto") == "ref"
    assert tops.resolve_mode("fused") == "ref"
    monkeypatch.setenv("REPRO_KERNEL_MODE", "fused")
    assert tops.resolve_mode("auto") == "pallas"
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    with pytest.raises(ValueError):
        tops.resolve_mode("auto")
    monkeypatch.setenv("REPRO_KERNEL_MODE", "bogus")
    with pytest.raises(ValueError):
        tops.resolve_mode("fused")


def test_cuda_passes_refuse_cpu_tensors():
    x = torch.from_numpy(ramp_frames(16, 1, 1, h=8, w=8))
    s = fused.make_static(x, **dict(KW, refine=False))
    with pytest.raises(ValueError, match="CUDA"):
        fused.cuda_premap(x, torch.ones(1, 3), s)
    with pytest.raises(ValueError, match="CUDA"):
        fused.cuda_tmap(x[..., 0], None, None, s)
    with pytest.raises(ValueError):
        fused.fused_dehaze_lanes(x.to("meta"), torch.zeros(1, 1, dtype=torch.int32),
                                 torch.ones(1, 3), torch.zeros(1, 2, dtype=torch.int32),
                                 refine=False, **{k: v for k, v in KW.items()})


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(fused, "_lib_handle", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        fused._lib()


def test_kernel_build_dir_in_checkout_and_installed(monkeypatch, tmp_path):
    root = _build.Path(_build.__file__).resolve().parents[3]
    assert _build.BUILD_DIR == root / "build" / "repro_torch_kernels"
    # An installed copy has no checkout around it: the user's cache.
    fake = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels" / "_build.py"
    monkeypatch.setattr(_build, "__file__", str(fake))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir() == tmp_path / "cache" / "repro_torch_kernels"


def test_cpu_wrapper_launches_no_kernel():
    x = torch.from_numpy(ramp_frames(18, L, B, h=H, w=W))
    cf, ci = (torch.from_numpy(a) for a in _carry())
    fused.reset_launches()
    fused.fused_dehaze_lanes(x, torch.from_numpy(_ids(0)), cf, ci,
                             refine=True, **KW)
    assert set(fused.launches) == set(fused.PASSES + fused.TILED_PASSES)
    assert not any(fused.launches.values())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.from_numpy(ramp_frames(17, L, B, h=48, w=64)).cuda()
    cf, ci = (torch.from_numpy(a).cuda() for a in _carry())
    ids = torch.from_numpy(_ids(0)).cuda()
    for algorithm, topk in (("dcp", 1), ("cap", 4)):
        kw = dict(KW, algorithm=algorithm, topk=topk, refine=True)
        got = fused.fused_dehaze_lanes(x, ids, cf, ci, **kw)
        torch.cuda.synchronize()
        want = tref.fused_dehaze_lanes(x, ids, cf, ci, **kw)
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).abs().max()) <= 1e-3
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g, w)
        # The tiled passes: each against its plain pass, the sequence
        # against the ten passes bit for bit.
        s = fused.make_static(x, **kw)
        ten = fused.run_passes(x, ids, cf, ci, s)
        for g, t in zip(got, ten):
            assert torch.equal(g, t)
        t_raw, g, keys = fused.cuda_tmap_tile(x, cf, s)
        for a, b in zip((t_raw, g, keys), fused.plain_tmap_tile(x, cf, s)):
            assert torch.equal(a, b)
        keys = keys if topk == 1 else fused.cuda_topk_block(t_raw, s)
        a_seq, *carry = fused.cuda_select_ema(keys, x, ids, cf, ci, s)
        for a, b in zip([a_seq, *carry],
                        fused.plain_select_ema(keys, x, ids, cf, ci, s)):
            assert float((a.float() - b.float()).abs().max()) <= 1e-6
        ab = fused.cuda_guided_ab(g, t_raw, s)
        assert float((ab - fused.plain_guided_ab(g, t_raw, s)).abs().max()) <= 1e-3
        for a, b in zip(fused.cuda_refine_recover(x, t_raw, g, ab, a_seq, s),
                        fused.plain_refine_recover(x, t_raw, g, ab, a_seq, s)):
            assert float((a - b).abs().max()) <= 1e-3
        # The transmission stage: its tiled sequence against its plain
        # version, and against the ten passes bit for bit.
        tkw = {k: v for k, v in kw.items()
               if k not in ("t0", "gamma", "period", "lam")}
        fused.reset_launches()
        got = fused.fused_transmission_lanes(x, cf, **tkw)
        torch.cuda.synchronize()
        assert fused.transmission_launches["tmap_tile"] == 1
        assert fused.transmission_launches["premap"] == 0
        want = tref.fused_transmission_lanes(x, cf, **tkw)
        for g, w, tol in zip(got, want, (1e-3, 1e-5, 1e-5)):
            assert float((g - w).abs().max()) <= tol
        for g, t in zip(got, fused.run_transmission_passes(x, cf, s)):
            assert torch.equal(g, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,radius,gf_radius",
                         [("uint8", 7, 60), ("float32", 37, 4),
                          ("bfloat16", 3, 46), ("float32", 36, 45)])
def test_cuda_wide_windows_pick_the_pass_sequence(dtype, radius, gf_radius):
    """Where a window's halo does not fit a tiled pass's block, the wrapper
    runs the ten passes (chosen before anything launches) and a tiled pass
    called alone raises; at the widest windows that fit it runs the tiled
    passes. Either way the result matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, x = wire(ramp_frames(20, L, B, h=48, w=64), dtype)
    x = x.cuda()
    cf, ci = (torch.from_numpy(a).cuda() for a in _carry())
    ids = torch.from_numpy(_ids(0)).cuda()
    kw = dict(KW, radius=radius, gf_radius=gf_radius, refine=True)
    s = fused.make_static(x, **kw)
    fits = (radius, gf_radius) == (36, 45)
    assert fused.tiled_fits(s) == fits
    fused.reset_launches()
    got = fused.fused_dehaze_lanes(x, ids, cf, ci, **kw)
    torch.cuda.synchronize()
    assert fused.launches["tmap_tile"] == int(fits)
    assert fused.launches["premap"] == int(not fits)
    want = tref.fused_dehaze_lanes(x, ids, cf, ci, **kw)
    tol = 2e-2 if dtype == "bfloat16" else 1e-3
    for g, w in zip(got[:2], want[:2]):
        assert float((g.float() - w.float()).abs().max()) <= tol
    for g, w in zip(got[2:], want[2:]):
        assert float((g.float() - w.float()).abs().max()) <= 1e-5
    for g, t in zip(got, fused.run_passes(x, ids, cf, ci, s)):
        assert torch.equal(g, t)
    if not fits:
        with pytest.raises(RuntimeError, match="cudaError_t"):
            t_raw, g, keys = fused.cuda_tmap_tile(x, cf, s)
            fused.cuda_guided_ab(g, t_raw, s)
