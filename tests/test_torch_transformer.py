"""PyTorch port, the LM (``repro_torch.models.transformer``) held to the JAX
package's ``repro.models.transformer`` on the CPU, at each of the four LM
ids' ``smoke_config()`` (float32): the reference's own
``init_params(jax.random.key(0), table)`` carried across by
``common.from_reference``, the same seeded numpy tokens through both (the
JAX side jitted).

Tolerances: logits within 1e-4 x max |logit| of the reference's, the aux
and the loss within 1e-4 x max(1, |value|), each gradient leaf within
1e-4 x max |g| of ``jax.grad``'s, the KV cache within 1e-4 x max |cache|
and ``pos`` exact. Cases: forward, loss and gradients; prefill (``max_len``
32) plus one decode step, mirroring ``tests/test_models.py``; token ids
outside the vocabulary (a negative id counts from the end, as JAX's
clipped gather takes it, then ids clip); llama4 at ``s > chunk_attn``
(the chunked path) with a prefill of 24 tokens and decodes in the
window; a decode past ``max_len`` (the cache write clamps); a moonshot
MoE whose capacity factor drops tokens (``top_e`` equal wherever the
top-k margin exceeds 1e-5, ``y`` within tolerance); ``remat`` on and off
under both policies giving equal gradients; the param tables and cache
helpers against the reference's; a mesh of several devices given as a
mapping of sizes refused (the model axis runs on gloo ranks in
``tests/test_torch_model_axis.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcm
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import common as cm
from repro_torch.models import transformer as T
from repro_torch.models.steps import value_and_grad
from repro_torch.tree import tree_flatten, tree_flatten_with_path

torch.set_num_threads(1)

RTOL = 1e-4
LMS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "granite-20b",
       "llama3-8b")


def _params(cfg_j, cfg_t):
    """(reference params as numpy, port params on the CPU) for one pair of
    configs with the same table."""
    table = JT.lm_param_table(cfg_j)
    jp = jax.jit(lambda k: jcm.init_params(k, table))(jax.random.key(0))
    jp = jax.tree.map(np.asarray, jp)
    return jp, cm.from_reference(jp, T.lm_param_table(cfg_t), device="cpu")


@pytest.fixture(scope="module")
def lm():
    """By arch: (reference params, port params, jax cfg, port cfg)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jconfigs.get_module(arch).smoke_config()
            tcfg = configs.get_module(arch).smoke_config()
            cache[arch] = (*_params(jcfg, tcfg), jcfg, tcfg)
        return cache[arch]
    return get


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, scale=None, rtol=RTOL, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    assert np.isfinite(got).all(), msg
    s = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(s, 1e-30),
                               err_msg=msg)


def _batch(toks):
    labels = np.roll(toks, -1, 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("arch", LMS)
def test_forward_loss_and_grads_match_reference(arch, lm):
    jp, tp, jcfg, tcfg = lm(arch)
    toks = _tokens(2, 16, tcfg.vocab)
    jb, tb = _batch(toks)
    want, waux = jax.jit(JT.make_forward(jcfg))(jp, jb["tokens"])
    got, aux = T.make_forward(tcfg)(tp, tb["tokens"])
    _close(got, want, msg="logits")
    _close(aux, waux, scale=max(1.0, abs(float(waux))), msg="aux")
    if tcfg.moe_experts:
        assert float(aux) > 0.0

    (wl, wm), wg = jax.jit(jax.value_and_grad(JT.make_loss_fn(jcfg),
                                              has_aux=True))(jp, jb)
    loss, metrics, grads = value_and_grad(T.make_loss_fn(tcfg), tp, tb)
    assert sorted(metrics) == sorted(wm) == ["aux", "nll"]
    _close(loss, wl, scale=max(1.0, abs(float(wl))), msg="loss")
    _close(metrics["nll"], wm["nll"], scale=max(1.0, abs(float(wm["nll"]))))
    assert abs(float(metrics["nll"]) - np.log(tcfg.vocab)) < 1.5
    gl = tree_flatten_with_path(grads)[0]
    wl_ = jax.tree_util.tree_flatten_with_path(wg)[0]
    assert [p for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl_]
    for (path, g), (_, w) in zip(gl, wl_):
        _close(g, w, msg=path)


def _assert_cache(got, want):
    assert int(got["pos"]) == int(want["pos"])
    assert got["pos"].dtype == torch.int32 and got["pos"].shape == ()
    for name in ("k", "v"):
        _close(got[name], want[name], msg=name)


@pytest.mark.parametrize("arch", LMS)
def test_prefill_and_decode_match_reference(arch, lm):
    jp, tp, jcfg, tcfg = lm(arch)
    toks = _tokens(2, 16, tcfg.vocab, seed=2)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    wlast, wcache = jax.jit(JT.make_prefill(jcfg, max_len=32))(jp, jt[:, :8])
    last, cache = T.make_prefill(tcfg, max_len=32)(tp, tt[:, :8])
    assert last.shape == (2, tcfg.vocab)
    _close(last, wlast, msg="prefill logits")
    _assert_cache(cache, wcache)
    assert int(cache["pos"]) == 8 and cache["k"].shape[2] == 32
    wlg, wcache2 = jax.jit(JT.make_decode_step(jcfg))(jp, wcache, jt[:, 8:9])
    k_before = cache["k"]
    lg, cache2 = T.make_decode_step(tcfg)(tp, cache, tt[:, 8:9])
    assert lg.shape == (2, 1, tcfg.vocab)
    assert cache2["k"] is k_before                    # written in place
    assert int(cache2["pos"]) == 9
    _close(lg, wlg, msg="decode logits")
    _assert_cache(cache2, wcache2)


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_out_of_range_token_ids_are_clipped(arch, lm):
    jp, tp, jcfg, tcfg = lm(arch)
    toks = _tokens(2, 8, tcfg.vocab, seed=3)
    v = tcfg.vocab
    toks[0, 1], toks[0, 3], toks[1, 5], toks[1, 0] = -5, -3 * v, v + 7, v
    want, _ = jax.jit(JT.make_forward(jcfg))(jp, jnp.asarray(toks))
    got, _ = T.make_forward(tcfg)(tp, torch.from_numpy(toks))
    _close(got, want)
    # a negative id counts from the end, then ids clip into the vocabulary
    clipped = np.clip(np.where(toks < 0, toks + v, toks), 0, v - 1)
    same, _ = T.make_forward(tcfg)(tp, torch.from_numpy(clipped))
    assert torch.equal(got, same)


def test_llama4_chunked_attention_and_window(lm):
    """s = 32 > chunk_attn = 8: the chunked layers attend within 8-token
    blocks (layer 3 is global); a 24-token prefill, then decodes whose
    chunked layers attend to the window ending at the new token."""
    jp, tp, jcfg, tcfg = lm("llama4-scout-17b-a16e")
    assert T._layer_flags(tcfg) == (False, False, False, True)
    toks = _tokens(1, 32, tcfg.vocab, seed=4)
    want, _ = jax.jit(JT.make_forward(jcfg))(jp, jnp.asarray(toks))
    got, _ = T.make_forward(tcfg)(tp, torch.from_numpy(toks))
    _close(got, want)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    wlast, wcache = jax.jit(JT.make_prefill(jcfg, max_len=30))(jp, jt[:, :24])
    last, cache = T.make_prefill(tcfg, max_len=30)(tp, tt[:, :24])
    _close(last, wlast)
    _assert_cache(cache, wcache)
    jdec, tdec = jax.jit(JT.make_decode_step(jcfg)), T.make_decode_step(tcfg)
    for i in range(24, 27):
        wlg, wcache = jdec(jp, wcache, jt[:, i:i + 1])
        lg, cache = tdec(tp, cache, tt[:, i:i + 1])
        _close(lg, wlg, msg=f"decode {i}")
        _assert_cache(cache, wcache)


def test_cache_write_clamps_at_the_end(lm):
    """A decode past ``max_len`` writes where ``dynamic_update_slice`` would
    (its start clamped to fit), as the reference does."""
    jp, tp, jcfg, tcfg = lm("llama3-8b")
    toks = _tokens(1, 10, tcfg.vocab, seed=5)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    wlast, wcache = jax.jit(JT.make_prefill(jcfg, max_len=8))(jp, jt[:, :8])
    last, cache = T.make_prefill(tcfg, max_len=8)(tp, tt[:, :8])
    wlg, wcache = jax.jit(JT.make_decode_step(jcfg))(jp, wcache, jt[:, 8:10])
    lg, cache = T.make_decode_step(tcfg)(tp, cache, tt[:, 8:10])
    _close(lg, wlg)
    _assert_cache(cache, wcache)
    assert int(cache["pos"]) == 10


def test_moe_drops_tokens_like_the_reference(lm):
    """moonshot's smoke MoE (8 experts, top-2) at capacity factor 0.5:
    tokens past an expert's capacity drop. ``top_e`` equals the reference's
    wherever the top-k margin exceeds 1e-5, and ``y``, aux and the whole
    forward are within tolerance."""
    jcfg = jconfigs.get_module("moonshot-v1-16b-a3b").smoke_config(
        moe_capacity_factor=0.5)
    tcfg = configs.get_module("moonshot-v1-16b-a3b").smoke_config(
        moe_capacity_factor=0.5)
    jp, tp = lm("moonshot-v1-16b-a3b")[:2]
    x = np.random.default_rng(6).standard_normal((48, tcfg.d_model)).astype(
        np.float32)
    names = ("router", "w_gate", "w_up", "w_down")
    jw = [jnp.asarray(jp["layers"][n][0]) for n in names]
    tw = [tp["layers"][n][0] for n in names]
    wy, waux = JT._moe_local(jnp.asarray(x), *jw, cfg=jcfg, model_axis=None,
                             n_model=1)
    y, aux = T._moe_local(torch.from_numpy(x), *tw, cfg=tcfg)
    _close(y, wy, msg="y")
    _close(aux, waux, scale=1.0, msg="aux")

    jw_, je, jprobs = JT._route(jnp.asarray(x), jw[0], jcfg)
    tw_, te, tprobs = T._route(torch.from_numpy(x), tw[0], tcfg)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    k = tcfg.moe_topk
    margin = np.minimum(srt[:, k - 1] - srt[:, k], np.min(
        np.diff(srt[:, :k][:, ::-1], axis=-1), axis=-1, initial=np.inf))
    clear = margin > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(te.numpy()[clear], np.asarray(je)[clear])
    _close(tw_, jw_)
    cap = max(1, int(np.ceil(48 * k / tcfg.moe_experts * 0.5)))
    counts = np.bincount(te.numpy().reshape(-1), minlength=tcfg.moe_experts)
    dropped = np.maximum(counts - cap, 0).sum()
    assert dropped > 0, (counts, cap)

    toks = _tokens(2, 16, tcfg.vocab, seed=7)
    want, _ = jax.jit(JT.make_forward(jcfg))(jp, jnp.asarray(toks))
    got, _ = T.make_forward(tcfg)(tp, torch.from_numpy(toks))
    _close(got, want)


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_remat_policies_give_equal_gradients(arch, lm):
    _, tp, _, tcfg = lm(arch)
    toks = _tokens(2, 16, tcfg.vocab, seed=8)
    _, tb = _batch(toks)
    want = value_and_grad(T.make_loss_fn(tcfg), tp, tb)
    for policy in ("minimal", "save_sums"):
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        got = value_and_grad(T.make_loss_fn(cfg), tp, tb)
        assert torch.equal(got[0], want[0]), policy
        for g, w in zip(tree_flatten(got[2])[0], tree_flatten(want[2])[0]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-7 * float(
                w.abs().max()) + 1e-12, msg=policy)


# --- tables, cache helpers, meshes ----------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", LMS)
def test_param_tables_match_reference(arch, which):
    jcfg = getattr(jconfigs.get_module(arch), which)()
    tcfg = getattr(configs.get_module(arch), which)()
    jt, tt = JT.lm_param_table(jcfg), T.lm_param_table(tcfg)
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
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.param_count(padded=True) == jcfg.param_count(padded=True)
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert T.lm_rules(tcfg) == JT.lm_rules(jcfg)
    assert all(m.is_meta for m in tree_flatten(cm.param_shapes(tt))[0])


def test_cache_helpers_match_reference():
    tcfg = configs.get_module("llama4-scout-17b-a16e").smoke_config()
    jcfg = jconfigs.get_module("llama4-scout-17b-a16e").smoke_config()
    cache = T.init_cache(tcfg, 3, 20, device="cpu")
    want = JT.init_cache(jcfg, 3, 20)
    meta = T.cache_shapes(tcfg, 3, 20)
    wmeta = JT.cache_shapes(jcfg, 3, 20)
    for name in ("k", "v", "pos"):
        assert tuple(cache[name].shape) == tuple(want[name].shape)
        assert cm.dtype_name(cache[name].dtype) == want[name].dtype.name
        assert not cache[name].any()
        assert meta[name].is_meta and tuple(meta[name].shape) == \
            tuple(wmeta[name].shape)
    specs = T.cache_pspecs(tcfg, ("pod", "data"))
    wspecs = JT.cache_pspecs(jcfg, ("pod", "data"))
    assert {k: tuple(v) for k, v in wspecs.items()} == specs
    with pytest.raises(RuntimeError):
        T.init_cache(tcfg, 1, 4)                  # CUDA by default, no card


def test_model_axis_is_refused():
    """A mesh of more than one device given as a mapping of sizes is
    refused: its collectives need a DeviceMesh's groups (the model axis
    itself runs on gloo ranks, ``tests/test_torch_model_axis.py``)."""
    cfg = configs.get_module("moonshot-v1-16b-a3b").smoke_config()
    for make in (T.make_forward, T.make_loss_fn, T.make_decode_step,
                 T.make_prefill, T.make_moe_ffn):
        with pytest.raises(ValueError, match="needs a DeviceMesh"):
            make(cfg, {"data": 1, "model": 2})
        with pytest.raises(ValueError, match="needs a DeviceMesh"):
            make(cfg, {"data": 2, "model": 1})
        make(cfg, {"data": 1, "model": 1})
