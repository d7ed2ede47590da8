"""PyTorch port, the dehaze configuration registry, the back-compat aliases
and the launch-count helper: ``repro_torch.configs`` against the JAX
package's ``repro.configs`` (the dehaze ids; every assigned id resolves
and an unknown one raises; the LM and diffusion ids with the checks of
the reference's ``tests/test_registry.py``: the published configs,
parameter counts, MoE active params, head dims of 128, exactly three
documented ``long_500k`` skips, the diffusion shapes and ``all_cells``); ``ops.fused_dehaze_dcp``,
``ops.fused_transmission_dcp``, ``fused.fused_dehaze_dcp``,
``ref.fused_dehaze_dcp`` and ``ref.fused_transmission_dcp`` against the
JAX aliases on the same numpy inputs; ``ops.launch_count``.

The aliases take the port's plain route on the CPU; the JAX side runs the
Pallas kernels in interpret mode (``ops``, ``fused``) or its ``ref``, as
``tests/test_fused.py`` runs them. Tolerances: J/t 1e-4, a_seq and A 1e-5
(the reference's kernel-vs-oracle level), ``last_update`` exact. The
launch counts are shown off the CPU on meta tensors with a fake kernel
library (as ``tests/test_torch_merge_ema.py`` shows the state sync's).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs
from repro_torch.core import DehazeConfig, PlacementSpec
from repro_torch.core import normalize as tn
from repro_torch.core import pipeline
from repro_torch.kernels import fused, ops, ref, staged

from _torch_common import as_np, counter_snapshot, ramp_frames
from _torch_common import launch_counters_restored  # noqa: F401 (autouse)

torch.set_num_threads(1)

DEHAZE = ("dehaze-dcp", "dehaze-cap")
VISION = ("vit-l16", "efficientnet-b7", "resnet-50", "convnext-b")
LMS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "granite-20b",
       "llama3-8b")
DIFFUSION = ("dit-l2", "unet-sdxl")
KW = dict(radius=3, omega=0.95, refine=True, gf_radius=4, gf_eps=1e-3)
DEHAZE_KW = dict(KW, t0=0.1, gamma=1.0, period=2, lam=0.3)


# --- the registry ------------------------------------------------------------

@pytest.mark.parametrize("arch", DEHAZE)
@pytest.mark.parametrize("kw", [{}, dict(topk=4, io_dtype="uint8")])
def test_dehaze_configs_match_jax(arch, kw):
    mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (
        arch, "dehaze")
    for name in ("config", "smoke_config"):
        got, want = getattr(mod, name)(**kw), getattr(jmod, name)(**kw)
        assert isinstance(got, DehazeConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        got.validate()
    assert mod.smoke_config().kernel_mode == "ref"


def test_shapes_and_cells_match_jax():
    assert configs.DEHAZE_SHAPES == jconfigs.DEHAZE_SHAPES
    assert configs.FAMILY_SHAPES == jconfigs.FAMILY_SHAPES == {
        "dehaze": jconfigs.DEHAZE_SHAPES, "vision": jconfigs.VISION_SHAPES,
        "lm": jconfigs.LM_SHAPES, "diffusion": jconfigs.DIFFUSION_SHAPES}
    assert sorted(configs.ARCH_MODULES) == sorted(DEHAZE + VISION + LMS
                                                  + DIFFUSION)
    assert list(configs.ARCH_MODULES) == list(jconfigs.ARCH_MODULES)
    for arch in DEHAZE:
        assert configs.shapes_for(arch) == jconfigs.shapes_for(arch)
        for shape in configs.shapes_for(arch):
            assert configs.cell_skip_reason(arch, shape) is None
            assert jconfigs.cell_skip_reason(arch, shape) is None
    with pytest.raises(KeyError):
        configs.cell_skip_reason("dehaze-dcp", "train_4k")


def test_assigned_and_dehaze_ids_resolve_and_unknown_raises():
    """All ten ``ASSIGNED_ARCHS`` and both dehaze ids resolve to the
    reference's id and family; an unknown id raises ``KeyError`` naming
    the known ones."""
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert sorted(configs.ASSIGNED_ARCHS) == sorted(VISION + LMS + DIFFUSION)
    for arch in configs.ASSIGNED_ARCHS + DEHAZE:
        mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
        assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
        assert mod.ARCH_ID == arch
    with pytest.raises(KeyError, match="unknown arch") as e:
        configs.get_module("nope")
    assert "'nope'" in str(e.value)
    for arch in ("dehaze-dcp", "vit-l16", "llama3-8b", "dit-l2", "unet-sdxl"):
        assert arch in str(e.value)


# --- the diffusion ids (the reference's tests/test_registry.py) ------------------

@pytest.mark.parametrize("arch", DIFFUSION)
@pytest.mark.parametrize("kw", [{}, dict(remat=False, dtype="float32")])
def test_diffusion_configs_match_jax(arch, kw):
    mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (
        arch, "diffusion")
    assert dataclasses.asdict(mod.config(**kw)) == \
        dataclasses.asdict(jmod.config(**kw))
    assert dataclasses.asdict(mod.smoke_config()) == \
        dataclasses.asdict(jmod.smoke_config())
    assert mod.config().torch_dtype == torch.bfloat16 and mod.config().remat
    assert mod.smoke_config().torch_dtype == torch.float32
    assert configs.shapes_for(arch) == jconfigs.shapes_for(arch) == \
        jconfigs.DIFFUSION_SHAPES
    for shape in configs.DIFFUSION_SHAPES:
        assert configs.cell_skip_reason(arch, shape) is None


def test_exact_assigned_diffusion_configs():
    c = configs.get_module("dit-l2").config()
    assert (c.img_res, c.patch, c.n_layers, c.d_model, c.n_heads) == \
        (256, 2, 24, 1024, 16)
    assert (c.latent_res, c.n_tokens(), c.n_tokens(1024)) == (32, 256, 4096)
    c = configs.get_module("unet-sdxl").config()
    assert (c.img_res, c.ch, c.ch_mult, c.n_res_blocks, c.transformer_depth,
            c.ctx_dim) == (1024, 320, (1, 2, 4), 2, (1, 2, 10), 2048)
    assert configs.get_module("unet-sdxl").config(img_res=512).latent_res == 64


def test_diffusion_shapes_and_all_cells_match_jax():
    assert configs.DIFFUSION_SHAPES == jconfigs.DIFFUSION_SHAPES
    assert set(configs.DIFFUSION_SHAPES) == {"train_256", "gen_1024",
                                             "gen_fast", "train_1024"}
    for dehaze in (False, True):
        assert configs.all_cells(dehaze) == jconfigs.all_cells(dehaze)
    assert len(configs.all_cells()) == 40
    assert len(configs.all_cells(include_dehaze=True)) == 48
    assert ("dit-l2", "gen_1024") in configs.all_cells()


# --- the LM ids (the reference's tests/test_registry.py) -----------------------

@pytest.mark.parametrize("arch", LMS)
def test_lm_configs_match_jax(arch):
    mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (
        arch, "lm")
    for name in ("config", "smoke_config"):
        got, want = getattr(mod, name)(), getattr(jmod, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    kw = dict(remat_policy="save_sums", moe_capacity_factor=0.5)
    assert dataclasses.asdict(mod.config(**kw)) == \
        dataclasses.asdict(jmod.config(**kw))
    assert mod.config().torch_dtype == torch.bfloat16
    assert mod.smoke_config().torch_dtype == torch.float32
    assert configs.shapes_for(arch) == jconfigs.shapes_for(arch) == \
        jconfigs.LM_SHAPES
    for shape in configs.LM_SHAPES:
        assert configs.cell_skip_reason(arch, shape) == \
            jconfigs.cell_skip_reason(arch, shape)


def test_exact_assigned_lm_configs():
    c = configs.get_module("moonshot-v1-16b-a3b").config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab, c.moe_experts, c.moe_topk) == \
        (48, 2048, 16, 16, 1408, 163840, 64, 6)
    c = configs.get_module("llama4-scout-17b-a16e").config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab, c.moe_experts, c.moe_topk, c.chunk_attn,
            c.global_every) == (48, 5120, 40, 8, 8192, 202048, 16, 1, 8192, 4)
    c = configs.get_module("granite-20b").config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (52, 6144, 48, 1, 24576, 49152)
    c = configs.get_module("llama3-8b").config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (32, 4096, 32, 8, 14336, 128256)


@pytest.mark.parametrize("arch,lo,hi", [("llama3-8b", 7.5e9, 8.5e9),
                                        ("granite-20b", 26e9, 30e9),
                                        ("moonshot-v1-16b-a3b", 26e9, 30e9),
                                        ("llama4-scout-17b-a16e", 95e9, 110e9)])
def test_lm_param_counts(arch, lo, hi):
    c, jc = configs.get_module(arch).config(), jconfigs.get_module(arch).config()
    assert lo < c.param_count() < hi
    assert c.param_count() == jc.param_count()
    assert c.param_count(padded=True) == jc.param_count(padded=True)
    assert c.active_param_count() == jc.active_param_count()


def test_active_params_moe_and_head_dims():
    n_act = configs.get_module("moonshot-v1-16b-a3b").config().active_param_count()
    assert 1.5e9 < n_act < 4.5e9, n_act
    for arch in LMS:
        c = configs.get_module(arch).config()
        assert c.head_dim == 128 and c.d_model == c.n_heads * 128


def test_documented_skips_are_exactly_three():
    cells = [(a, s) for a in configs.ARCH_MODULES for s in configs.shapes_for(a)]
    skips = [(a, s) for a, s in cells if configs.cell_skip_reason(a, s)]
    assert sorted(skips) == [("granite-20b", "long_500k"),
                             ("llama3-8b", "long_500k"),
                             ("moonshot-v1-16b-a3b", "long_500k")]
    assert configs.SUBQUADRATIC_LMS == jconfigs.SUBQUADRATIC_LMS
    assert configs.cell_skip_reason("llama4-scout-17b-a16e", "long_500k") is None
    assert configs.cell_skip_reason("llama3-8b", "long_500k") == \
        jconfigs.cell_skip_reason("llama3-8b", "long_500k")


# --- the aliases ---------------------------------------------------------------

def _inputs():
    x = ramp_frames(24, 2, h=24, w=32)
    a = np.asarray([0.9, 0.92, 0.88], np.float32)
    return x, a, np.arange(2, dtype=np.int32)


def _jax_state(a):
    return (jnp.asarray(a), jnp.asarray(-(2 ** 30), jnp.int32),
            jnp.asarray(False))


def _torch_state(a):
    return (torch.from_numpy(a), torch.tensor(-(2 ** 30), dtype=torch.int32),
            torch.tensor(False))


def _compare_dehaze(got, want):
    for g, w in zip(got[:2], want[:2]):                      # J, t
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-4, rtol=0)
    for g, w in zip(got[2:4], want[2:4]):                    # a_seq, A
        np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5, rtol=0)
    assert int(got[4]) == int(want[4])


def test_fused_dehaze_dcp_aliases_match_jax():
    x, a, ids = _inputs()
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids)
    jx, jids = jnp.asarray(x), jnp.asarray(ids)
    want = jops.fused_dehaze_dcp(jx, jids, *_jax_state(a), mode="interpret",
                                 **DEHAZE_KW)
    got = ops.fused_dehaze_dcp(tx, tids, *_torch_state(a), mode="fused",
                               **DEHAZE_KW)
    _compare_dehaze(got, want)
    # The kernel alias and the plain alias against theirs.
    j_kernel = jfused.fused_dehaze_dcp_pallas(jx, jids, *_jax_state(a),
                                              interpret=True, **DEHAZE_KW)
    _compare_dehaze(fused.fused_dehaze_dcp(tx, tids, *_torch_state(a),
                                           **DEHAZE_KW), j_kernel)
    _compare_dehaze(ref.fused_dehaze_dcp(tx, tids, *_torch_state(a),
                                         **DEHAZE_KW),
                    jref.fused_dehaze_dcp(jx, jids, *_jax_state(a),
                                          **DEHAZE_KW))
    # Each alias is its entry point with algorithm="dcp".
    full = ops.fused_dehaze(tx, tids, *_torch_state(a), algorithm="dcp",
                            mode="fused", **DEHAZE_KW)
    assert all(torch.equal(g, w) for g, w in zip(got, full))


def test_fused_transmission_dcp_aliases_match_jax():
    x, a, _ = _inputs()
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    want = jops.fused_transmission_dcp(jx, jnp.asarray(a), mode="interpret",
                                       **KW)
    for got in (ops.fused_transmission_dcp(tx, torch.from_numpy(a),
                                           mode="fused", **KW),
                ref.fused_transmission_dcp(tx, torch.from_numpy(a), **KW)):
        np.testing.assert_allclose(as_np(got[0]), as_np(want[0]), atol=1e-4,
                                   rtol=0)
        for g, w in zip(got[1:], want[1:]):               # t_min, candidate
            np.testing.assert_allclose(as_np(g), as_np(w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        as_np(jref.fused_transmission_dcp(jx, jnp.asarray(a), **KW)[0]),
        as_np(want[0]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fpb", [1, 4, -1])
def test_frames_per_block_other_than_zero_raises(fpb):
    x, a, ids = _inputs()
    with pytest.raises(ValueError, match="frames_per_block"):
        ops.fused_dehaze_dcp(torch.from_numpy(x), torch.from_numpy(ids),
                             *_torch_state(a), frames_per_block=fpb,
                             mode="fused", **DEHAZE_KW)


# --- launch counts -------------------------------------------------------------

def _lane_step(device):
    """A staged lane step (3 lanes x 2 frames of 8x12) and its inputs."""
    cfg = DehazeConfig(kernel_mode="pallas", patch_radius=1, gf_radius=2,
                       update_period=2, lam=0.3)
    step = pipeline._make_local_step(cfg, PlacementSpec.lane_batched(), True,
                                     None)
    frames = torch.rand(3, 2, 8, 12, 3).to(device)
    ids = torch.arange(6, dtype=torch.int32).reshape(3, 2).to(device)
    return step, (frames, ids, tn.init_atmo_state_lanes(3, device))


def test_launch_count_is_zero_on_the_cpu():
    """The plain versions launch nothing; counts set before the call stay
    (``launch_counters_restored`` puts them back after the test)."""
    staged.launches["box_filter"] = 5
    fused.launches["tmap_tile"] = 3
    before = counter_snapshot()
    step, args = _lane_step("cpu")
    assert ops.launch_count(step, *args) == {"total": 0}
    x, a, ids = _inputs()
    assert ops.launch_count(
        ops.fused_dehaze_dcp, torch.from_numpy(x), torch.from_numpy(ids),
        *_torch_state(a), mode="fused", **DEHAZE_KW) == {"total": 0}
    assert counter_snapshot() == before


def test_launch_count_counts_a_staged_step_by_difference(monkeypatch):
    """Off the CPU (meta tensors, a fake kernel library) a staged lane
    step's count is its kernels, one tick's worth, while the counters keep
    the counts they had before the call plus the step's."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(staged, "_lib", lambda: Lib())
    monkeypatch.setattr(staged, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    # Seeded counts; the module's autouse ``launch_counters_restored`` puts
    # every counter back afterwards, the step's own launches too.
    staged.launches["box_filter"] = 5
    staged.launches["merge_topk"] = 2
    step, args = _lane_step("meta")
    before = counter_snapshot()
    counts = ops.launch_count(step, *args)
    assert counts == {"staged.dark_channel": 1, "staged.box_filter": 6,
                      "staged.atmolight": 1, "staged.recover": 1,
                      "staged.merge_ema": 1, "total": 10}
    assert len(calls) == 10
    assert staged.launches["box_filter"] == 11
    assert staged.launches["merge_topk"] == 2
    assert counter_snapshot()[2:] == before[2:]
    names = ops.launch_counters()
    assert {f"staged.{k}" for k in staged.launches} <= set(names)
    assert {f"fused_transmission_halo.{k}" for k in fused.halo_launches} \
        <= set(names)
