"""PyTorch port, the model zoo's common layer (``repro_torch.models.common``)
held to the JAX package's ``repro.models.common`` on the same seeded numpy
inputs, on the CPU: the norms, rope, BatchNorm (train and inference) and
``bn_apply``, the embeddings, causal attention on its one-block and its
blocked path (a ragged last block, ``q_offset > 0``, GQA), the convs and
pools under SAME and VALID at strides 1 and 2 on even and odd sizes
(XLA's SAME pads ``total // 2`` before and the rest after), the leaves
``merge_bn_stats`` takes, the per-leaf mesh axes against the reference's
``PartitionSpec``s, ``init_params`` and ``from_reference``.

Tolerances (float32): 1e-5 absolute for the elementwise ops, the norms and
attention, 1e-4 for the convs and pools (sums over up to 5x5x6 terms in
another order); pools' maxima, selections and tables exactly."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import common as jcm
from repro_torch.models import common as cm
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from _torch_common import as_np

torch.set_num_threads(1)

TOL = 1e-5
CONV_TOL = 1e-4


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=0)


# --- norms, rope, BatchNorm, embeddings ----------------------------------------

def _norm_case(name):
    x = _rand(0, 2, 5, 6, 8)
    s, b = _rand(1, 8) + 1.0, _rand(2, 8)
    mean, var = _rand(3, 8), np.abs(_rand(4, 8)) + 0.5
    if name == "layer_norm":
        return cm.layer_norm(_t(x), _t(s), _t(b)), \
            jcm.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    if name == "rms_norm":
        return cm.rms_norm(_t(x), _t(s)), jcm.rms_norm(jnp.asarray(x),
                                                       jnp.asarray(s))
    if name == "group_norm":
        x = _rand(0, 2, 4, 5, 12)
        s, b = _rand(1, 12), _rand(2, 12)
        return cm.group_norm(_t(x), _t(s), _t(b), groups=8), \
            jcm.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                           groups=8)
    if name == "rope":
        x, pos = _rand(0, 2, 7, 3, 8), np.arange(7) + 3
        return cm.rope(_t(x), _t(pos)), jcm.rope(jnp.asarray(x),
                                                 jnp.asarray(pos))
    if name == "timestep_embedding":
        t = np.array([0, 3, 999], np.int32)
        return cm.timestep_embedding(_t(t), 16), \
            jcm.timestep_embedding(jnp.asarray(t), 16)
    if name == "posemb_sincos_2d":
        return cm.posemb_sincos_2d(3, 5, 16, device="cpu"), \
            jcm.posemb_sincos_2d(3, 5, 16)
    training = name.endswith("train")
    if name.startswith("batch_norm"):
        got = cm.batch_norm(_t(x), _t(s), _t(b), _t(mean), _t(var), training)
        want = jcm.batch_norm(*map(jnp.asarray, (x, s, b, mean, var)),
                              training)
        return got, want
    p = {"scale": s, "bias": b, "mean": mean, "var": var}
    y, new = cm.bn_apply({k: _t(v) for k, v in p.items()}, _t(x), training)
    jy, jnew = jcm.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), training)
    return (y,) + tuple(new[k] for k in sorted(new)), \
        (jy,) + tuple(jnew[k] for k in sorted(jnew))


@pytest.mark.parametrize("name", [
    "layer_norm", "rms_norm", "group_norm", "rope", "timestep_embedding",
    "posemb_sincos_2d", "batch_norm_train", "batch_norm_infer",
    "bn_apply_train", "bn_apply_infer"])
def test_elementwise_ops_match_reference(name):
    got, want = _norm_case(name)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_layer_norm_applies_scale_in_the_input_dtype():
    """bfloat16 in: normalised in float32, cast, then ``* scale + bias`` in
    bfloat16, as the reference does."""
    x, s, b = _rand(0, 3, 16), _rand(1, 16), _rand(2, 16)
    got = cm.layer_norm(_t(x).bfloat16(), _t(s).bfloat16(), _t(b).bfloat16())
    want = jcm.layer_norm(*(jnp.asarray(v).astype(jnp.bfloat16)
                            for v in (x, s, b)))
    assert got.dtype == torch.bfloat16
    _close(got, want, tol=2e-2)


# --- attention ------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,h,hkv,q_offset,kv_block", [
    (8, 8, 4, 4, 0, 1024),        # one block
    (6, 6, 4, 2, 0, 1024),        # one block, GQA
    (20, 20, 4, 4, 0, 8),         # blocked, ragged last block (20 = 8+8+4)
    (4, 20, 4, 2, 16, 8),         # blocked, decode-like offset, GQA
    (5, 17, 2, 1, 3, 4),          # blocked, rows with masked-out blocks
])
def test_causal_attention_matches_reference(sq, skv, h, hkv, q_offset,
                                            kv_block):
    q, k, v = _rand(0, 2, sq, h, 8), _rand(1, 2, skv, hkv, 8), \
        _rand(2, 2, skv, hkv, 8)
    got = cm.causal_attention(_t(q), _t(k), _t(v), q_offset=q_offset,
                              kv_block=kv_block)
    want = jcm.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=q_offset,
                                kv_block=kv_block)
    assert got.shape == (2, sq, h, 8)
    _close(got, want)
    assert torch.equal(cm._repeat_kv(_t(k), h // hkv),
                       _t(np.asarray(jcm._repeat_kv(jnp.asarray(k),
                                                    h // hkv))))


# --- convs and pools --------------------------------------------------------------

def _window_case(op, padding, stride, size):
    x = _rand(0, 2, size, size + 1, 6)
    if op == "conv2d":
        w = _rand(1, 3, 3, 6, 5) * 0.3
        return (cm.conv2d(_t(x), _t(w), stride=stride, padding=padding),
                jcm.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           padding=padding))
    if op == "conv2d_7x7":
        w = _rand(1, 7, 7, 6, 4) * 0.1
        return (cm.conv2d(_t(x), _t(w), stride=stride, padding=padding),
                jcm.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           padding=padding))
    if op == "depthwise_conv2d":
        w = _rand(1, 5, 5, 1, 6) * 0.3
        return (cm.depthwise_conv2d(_t(x), _t(w), stride=stride,
                                    padding=padding),
                jcm.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride, padding=padding))
    if op == "max_pool":
        return (cm.max_pool(_t(x), 3, stride, padding),
                jcm.max_pool(jnp.asarray(x), 3, stride, padding))
    return (cm.avg_pool(_t(x), 3, stride, padding),
            jcm.avg_pool(jnp.asarray(x), 3, stride, padding))


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("op", ["conv2d", "conv2d_7x7", "depthwise_conv2d",
                                "max_pool", "avg_pool"])
def test_windows_match_reference(op, padding, stride, size):
    got, want = _window_case(op, padding, stride, size)
    assert tuple(got.shape) == tuple(want.shape)
    if op == "max_pool":
        np.testing.assert_array_equal(as_np(got), as_np(want))
    else:
        _close(got, want, tol=CONV_TOL)


def test_same_padding_is_asymmetric_under_stride_two():
    """The trap the SAME rule guards: PyTorch's symmetric ``padding=1``
    gives the same shape as XLA's (0, 1) on an even input, not the same
    values."""
    assert cm._pads("SAME", (8, 8), (3, 3), 2) == ((0, 1), (0, 1))
    assert cm._pads("SAME", (224, 224), (7, 7), 2) == ((2, 3), (2, 3))
    assert cm._pads("SAME", (112, 112), (3, 3), 2) == ((0, 1), (0, 1))
    assert cm._pads("SAME", (9, 9), (3, 3), 2) == ((1, 1), (1, 1))
    x, w = _rand(0, 1, 8, 8, 2), _rand(1, 3, 3, 2, 2)
    sym = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2),
                                     _t(w).permute(3, 2, 0, 1), stride=2,
                                     padding=1).permute(0, 2, 3, 1)
    want = jcm.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2)
    assert sym.shape == want.shape
    assert np.abs(as_np(sym) - as_np(want)).max() > 1e-2
    _close(cm.conv2d(_t(x), _t(w), stride=2), want, tol=CONV_TOL)


# --- trees: BN-stat merge, mesh axes, init, carry-over ------------------------------

def _bn_tree(fill):
    return {"stem": np.full((2, 2), fill, np.float32),
            "stem_bn": {k: np.full(3, fill, np.float32)
                        for k in ("scale", "bias", "mean", "var")},
            "stage0_rest": {"bn1": {"mean": np.full((2, 3), fill, np.float32),
                                    "var": np.full((2, 3), fill, np.float32),
                                    "scale": np.full((2, 3), fill,
                                                     np.float32)},
                            "conv1": np.full((2, 1), fill, np.float32)},
            "blocks": [{"mean_pool": np.full(2, fill, np.float32),
                        "var": np.full(2, fill, np.float32)}]}


def test_merge_bn_stats_takes_the_reference_leaves():
    got = cm.merge_bn_stats(_bn_tree(0.0), _bn_tree(1.0))
    want = jcm.merge_bn_stats(_bn_tree(0.0), _bn_tree(1.0))
    got_paths = tree_flatten_with_path(got)[0]
    want_paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_paths] == [jax.tree_util.keystr(p)
                                         for p, _ in want_paths]
    picked = [float(np.asarray(l).ravel()[0]) for _, l in got_paths]
    assert picked == [float(np.asarray(l).ravel()[0]) for _, l in want_paths]
    assert sum(picked) == 5                  # the 5 mean/var leaves


def _axis_table(mod):
    names = ["vocab", "vocab_embed", "dm_embed", "heads", "kv_heads",
             "heads_flat", "mlp", "experts", "conv_out", "embed", "layers",
             "head_dim", None, "custom"]
    return {f"{a}_{d}": mod.ParamSpec((d, 3), (a, None), "float32")
            for a in names for d in (1000, 32, 6)}


@pytest.mark.parametrize("mesh", [None, {"data": 2, "model": 16},
                                  {"data": 4, "model": 2}])
@pytest.mark.parametrize("rules", [None, {"custom": ("data", "model"),
                                          "embed": "data"}])
def test_param_pspecs_match_reference(mesh, rules):
    jmesh = None if mesh is None else types.SimpleNamespace(shape=mesh)
    got = cm.param_pspecs(_axis_table(cm), rules, mesh)
    want = jcm.param_pspecs(_axis_table(jcm), rules, jmesh)
    assert sorted(got) == sorted(want)
    for k in got:
        assert isinstance(want[k], P)
        assert got[k] == tuple(want[k]), k


def test_init_params_and_shapes():
    table = {"w": cm.ParamSpec((4, 6), (None, "mlp"), "float32", scale=2.0),
             "layers": cm.ParamSpec((3, 8, 5), ("layers", "embed", None),
                                    "bfloat16"),
             "bn": cm.bn_table(7)}
    a = cm.init_params(table, 0, device="cpu")
    b = cm.init_params(table, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert a["layers"].dtype == torch.bfloat16 and a["w"].dtype == torch.float32
    assert torch.equal(a["bn"]["var"], torch.ones(7))
    assert torch.equal(a["bn"]["mean"], torch.zeros(7))
    assert cm.fanin_scale(table["layers"]) == jcm.fanin_scale(
        jcm.ParamSpec((3, 8, 5), ("layers", "embed", None)))
    big = cm.init_params({"w": cm.ParamSpec((400, 500), (None, None),
                                            "float32")}, 1, device="cpu")
    assert abs(float(big["w"].std()) - 1 / np.sqrt(400)) < 2e-3
    meta = cm.param_shapes(table)
    assert meta["layers"].is_meta and meta["layers"].shape == (3, 8, 5)
    assert meta["layers"].dtype == torch.bfloat16
    assert cm.param_count(table) == 24 + 120 + 28


def test_from_reference_carries_bits_and_checks_the_table():
    table = {"a": cm.ParamSpec((2, 3), (None, None), "bfloat16"),
             "b": cm.ParamSpec((4,), (None,), "float32")}
    ref = {"a": np.asarray(jnp.asarray(_rand(0, 2, 3)).astype(jnp.bfloat16)),
           "b": _rand(1, 4)}
    got = cm.from_reference(ref, table, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert got["a"].view(torch.int16).numpy().tobytes() == ref["a"].tobytes()
    assert np.array_equal(got["b"].numpy(), ref["b"])
    void = dict(ref, a=ref["a"].view("V2"))          # what np.savez stores
    assert torch.equal(cm.from_reference(void, table, device="cpu")["a"],
                       got["a"])
    with pytest.raises(ValueError, match="dtype"):
        cm.from_reference(dict(ref, b=ref["b"].astype(np.float64)), table,
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        cm.from_reference(dict(ref, b=_rand(1, 5)), table, device="cpu")
    with pytest.raises(ValueError, match="tree"):
        cm.from_reference({"a": ref["a"]}, table, device="cpu")
