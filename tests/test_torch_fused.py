"""PyTorch port, the fused megakernel: ``repro_torch.kernels.ops`` /
``kernels.fused`` against the JAX package's ``kernels.ops`` on the same
numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernels are held
against that plain version on the card (``chip_smoke.py``, and the
``cuda``-marked test below). Here the cells check the plain version and
the pass decomposition the card runs (``fused.run_passes`` through the
plain passes) against the reference, at the reference's own tolerances
(``tests/test_fused.py``): J/t 1e-4 with refine and 1e-5 without, a_seq
and the final A 1e-5, last_update/initialized exact, bfloat16 2e-2. The
fused transmission stage of the sharded step (its pass sequence through
the plain passes) is held to the Pallas kernels in interpret mode: t 1e-4,
t_min and the candidates 1e-5.
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
    """The lane form (per-lane A: frame row i reads lane i // B's) through
    the plain passes against ``fused_transmission_lanes_pallas``, and its
    L=1 view through ``ops`` against ``fused_transmission_pallas``."""
    x = ramp_frames(19, 2, 3, h=12, w=16)
    a = np.array([[0.9, 0.8, 0.85], [0.6, 0.7, 0.65]], np.float32)
    jx, tx = wire(x, dtype)
    kw = dict(TKW, algorithm=algorithm, topk=topk, refine=True)
    s = fused.make_static(tx, t0=0.1, gamma=1.0, period=1, lam=0.0, **kw)
    got = fused.run_transmission_passes(tx, torch.from_numpy(a), s,
                                        fused.TRANSMISSION_PLAIN_PASSES)
    want = fused_transmission_lanes_pallas(jx, jnp.asarray(a),
                                           interpret=True, **kw)
    _compare_transmission(got, want)
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
    assert set(fused.transmission_launches) == set(fused.TRANSMISSION_PASSES)
    assert not any(fused.transmission_launches.values())
    assert not any(fused.launches.values())
    with pytest.raises(ValueError, match=r"\(L, 3\)"):
        fused.fused_transmission_lanes(x, torch.ones(3), refine=True, **TKW)


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
    assert set(fused.launches) == set(fused.PASSES)
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
        # The transmission stage: its kernels against its plain version.
        tkw = {k: v for k, v in kw.items()
               if k not in ("t0", "gamma", "period", "lam")}
        got = fused.fused_transmission_lanes(x, cf, **tkw)
        torch.cuda.synchronize()
        want = tref.fused_transmission_lanes(x, cf, **tkw)
        for g, w, tol in zip(got, want, (1e-3, 1e-5, 1e-5)):
            assert float((g - w).abs().max()) <= tol
