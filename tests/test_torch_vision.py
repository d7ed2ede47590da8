"""PyTorch port, the vision zoo (``repro_torch.models.{resnet, convnext,
efficientnet, vit}`` and their ``configs``) held to the JAX package on the
CPU, at each id's ``smoke_config()`` in float32: the reference's own
``init_params(jax.random.key(0), table)`` carried across by
``common.from_reference``, the same seeded numpy images through both
forwards (the JAX side jitted).

Tolerances: logits within 1e-4 x max |logit| of the reference's; in
training mode (ResNet, EfficientNet) also every new running ``mean`` and
``var`` leaf within 1e-4 x max(1, max |leaf|); the loss values within 1e-5
relative. The training cases run at an odd resolution (33), where XLA's
SAME padding splits differently from an even one; the loss runs the
training forward at 32.
Training cases take 8 images: with 2, EfficientNet's last stages (1x1
spatial) take BatchNorm statistics over 2 values, where the reference's
own jitted and eager forwards differ by up to 0.4 x max |logit|. The
param tables (tree, shapes, dtypes, count) equal the reference's at both
``config()`` and ``smoke_config()`` without allocating, and the registry
resolves the four ids with the reference's configs, field for field."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcm
from repro_torch import configs
from repro_torch.models import common as cm
from repro_torch.tree import tree_flatten, tree_flatten_with_path

torch.set_num_threads(1)

LOGIT_RTOL = 1e-4
STAT_RTOL = 1e-4
VISION = ("resnet-50", "convnext-b", "efficientnet-b7", "vit-l16")
MODULES = {"resnet-50": ("resnet", "resnet_param_table"),
           "convnext-b": ("convnext", "convnext_param_table"),
           "efficientnet-b7": ("efficientnet", "efficientnet_param_table"),
           "vit-l16": ("vit", "vit_param_table")}
BN_MODELS = ("resnet-50", "efficientnet-b7")
PUBLISHED_DTYPE = {"resnet-50": "float32", "efficientnet-b7": "float32",
                   "convnext-b": "bfloat16", "vit-l16": "bfloat16"}


def _mods(arch):
    name, table = MODULES[arch]
    jmod = importlib.import_module(f"repro.models.{name}")
    tmod = importlib.import_module(f"repro_torch.models.{name}")
    return jmod, tmod, getattr(jmod, table), getattr(tmod, table)


@pytest.fixture(scope="module")
def zoo():
    """By arch: (reference params as numpy, port params on the CPU, the
    two smoke configs), made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jmod, tmod, jtable, ttable = _mods(arch)
            jcfg = jconfigs.get_module(arch).smoke_config()
            tcfg = configs.get_module(arch).smoke_config()
            table = jtable(jcfg)
            jp = jax.jit(lambda k: jcm.init_params(k, table))(
                jax.random.key(0))
            jp = jax.tree.map(np.asarray, jp)
            tp = cm.from_reference(jp, ttable(tcfg), device="cpu")
            cache[arch] = (jp, tp, jcfg, tcfg)
        return cache[arch]
    return get


def _images(n, res, seed=0):
    return np.random.default_rng(seed).random((n, res, res, 3)).astype(
        np.float32)


def _forwards(arch, jcfg, tcfg, training):
    jmod, tmod, _, _ = _mods(arch)
    if arch == "vit-l16":
        return jax.jit(jmod.make_forward(jcfg)), tmod.make_forward(tcfg)
    return (jax.jit(jmod.make_forward(jcfg, training=training)),
            tmod.make_forward(tcfg, training=training))


def _assert_logits(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


# Inference at 32 px for every id; training (ResNet, EfficientNet) at the
# odd 33 px. ``make_loss_fn`` runs their training forward at 32 px.
CASES = [(a, False, 32) for a in VISION] + [(a, True, 33) for a in BN_MODELS]


@pytest.mark.parametrize("arch,training,res", CASES)
def test_forward_matches_reference(arch, training, res, zoo):
    jp, tp, jcfg, tcfg = zoo(arch)
    x = _images(8 if training else 2, res, seed=res)
    jfwd, tfwd = _forwards(arch, jcfg, tcfg, training)
    want, got = jfwd(jp, jnp.asarray(x)), tfwd(tp, torch.from_numpy(x))
    if arch not in BN_MODELS:
        _assert_logits(got, want)
        return
    (got, new), (want, jnew) = got, want
    _assert_logits(got, want)
    got_leaves = tree_flatten_with_path(new)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(jnew)[0]
    assert [p for p, _ in got_leaves] == [jax.tree_util.keystr(p)
                                          for p, _ in want_leaves]
    n_stats = 0
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        if training and path.endswith(("['mean']", "['var']")):
            n_stats += 1
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0,
                atol=STAT_RTOL * max(1.0, np.abs(w).max()), err_msg=path)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    assert (n_stats > 0) == training


@pytest.mark.parametrize("arch", VISION)
def test_loss_fn_matches_reference(arch, zoo):
    jp, tp, jcfg, tcfg = zoo(arch)
    jmod, tmod, _, _ = _mods(arch)
    x = _images(8, 32, seed=7)                 # training-mode BN, as above
    labels = np.array([3, 11, 0, 15, 7, 7, 2, 9], np.int32)
    want, jaux = jax.jit(jmod.make_loss_fn(jcfg))(
        jp, {"images": jnp.asarray(x), "labels": jnp.asarray(labels)})
    got, aux = tmod.make_loss_fn(tcfg)(
        tp, {"images": torch.from_numpy(x), "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(aux["nll"]) == float(got)
    if arch == "vit-l16":
        assert float(aux["acc"]) == float(jaux["acc"])
    assert sorted(aux) == sorted(jaux)


# --- tables and registry -----------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", VISION)
def test_param_tables_match_reference(arch, which):
    _, _, jtable, ttable = _mods(arch)
    jt = jtable(getattr(jconfigs.get_module(arch), which)())
    tt = ttable(getattr(configs.get_module(arch), which)())
    is_j = lambda s: isinstance(s, jcm.ParamSpec)  # noqa: E731
    jleaves = jax.tree_util.tree_flatten_with_path(jt, is_leaf=is_j)[0]
    tleaves = tree_flatten_with_path(tt)[0]
    assert [p for p, _ in tleaves] == [jax.tree_util.keystr(p)
                                       for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert (t.shape, t.axes, t.init, t.scale) == \
            (tuple(j.shape), tuple(j.axes), j.init, j.scale), path
        assert cm.dtype_name(t.dtype) == jnp.dtype(j.dtype).name, path
    assert cm.param_count(tt) == jcm.param_count(jt)
    meta = cm.param_shapes(tt)
    assert all(m.is_meta for m in tree_flatten(meta)[0])


@pytest.mark.parametrize("arch", VISION)
def test_vision_registry_matches_reference(arch):
    mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
    assert (mod.ARCH_ID, mod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY) == (
        arch, "vision")
    for name in ("config", "smoke_config"):
        got, want = getattr(mod, name)(), getattr(jmod, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert mod.config().dtype == PUBLISHED_DTYPE[arch]
    assert mod.smoke_config().dtype == "float32"
    assert mod.config(dtype="float32").torch_dtype == torch.float32
    assert configs.shapes_for(arch) == jconfigs.shapes_for(arch) == \
        jconfigs.VISION_SHAPES
    for shape in configs.shapes_for(arch):
        assert configs.cell_skip_reason(arch, shape) is None
        assert jconfigs.cell_skip_reason(arch, shape) is None


def test_exact_assigned_vision_configs():
    """The published numbers, as the reference's ``test_registry.py``
    spot-checks them."""
    c = configs.get_module("vit-l16").config()
    assert (c.img_res, c.patch, c.n_layers, c.d_model, c.n_heads, c.d_ff) \
        == (224, 16, 24, 1024, 16, 4096)
    c = configs.get_module("efficientnet-b7").config()
    assert (c.img_res, c.width_mult, c.depth_mult) == (600, 2.0, 3.1)
    c = configs.get_module("resnet-50").config()
    assert (c.img_res, c.depths, c.width) == (224, (3, 4, 6, 3), 64)
    c = configs.get_module("convnext-b").config()
    assert (c.img_res, c.depths, c.dims) == \
        (224, (3, 3, 27, 3), (128, 256, 512, 1024))
    assert configs.VISION_SHAPES == jconfigs.VISION_SHAPES
    assert configs.FAMILY_SHAPES["vision"] == jconfigs.FAMILY_SHAPES["vision"]
