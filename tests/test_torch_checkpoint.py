"""PyTorch port, checkpoints and the synthetic streams
(``repro_torch.checkpoint``, ``repro_torch.data.synthetic``) held to the
JAX package's on the CPU: a checkpoint written by either package loads in
the other, float32 and bfloat16 leaves bit for bit (the reference's
bfloat16 leaves come back from ``np.savez`` as ``|V2``, and so do the
port's); ``keep`` removes the same steps; a leftover ``.tmp`` directory is
never read; ``AsyncCheckpointer.wait`` joins and re-raises; the three
streams yield bit-equal arrays for the same seed; the prefetcher keeps the
order and ends; and every default-device entry point of the slice raises
without CUDA."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.data import synthetic as jsyn
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointManager,
                                    load_pytree, save_pytree)
from repro_torch.data import synthetic as syn
from repro_torch.models import common as cm
from repro_torch.tree import tree_flatten, tree_leaves

torch.set_num_threads(1)


def _ref_tree():
    """A nested tree in the JAX package: float32, bfloat16 and int32 leaves,
    keys out of sorted order."""
    r = np.random.default_rng(0)
    return {"zeta": jnp.asarray(r.standard_normal((3, 4)), jnp.float32),
            "alpha": {"w": jnp.asarray(r.standard_normal((2, 5))).astype(
                          jnp.bfloat16),
                      "n": jnp.arange(6, dtype=jnp.int32)},
            "mid": [jnp.asarray(r.standard_normal(7), jnp.float32),
                    jnp.asarray(r.standard_normal((2, 2))).astype(
                        jnp.bfloat16)]}


def _like(tree):
    """The port's ``like`` of a reference tree: tensors of the same shapes
    and dtypes (bfloat16 where the reference's is)."""
    def one(a):
        a = np.asarray(a)
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" else \
            torch.from_numpy(np.zeros(0, a.dtype)).dtype
        return torch.zeros(a.shape, dtype=dt)
    return jax.tree.map(one, tree)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = _ref_tree()
    jax_save(str(tmp_path / "ck"), tree, extra={"step": 3})
    got, extra = load_pytree(str(tmp_path / "ck"), _like(tree))
    assert extra == {"step": 3}
    assert got["alpha"]["w"].dtype == torch.bfloat16
    assert got["alpha"]["n"].dtype == torch.int32
    want = jax.tree_util.tree_leaves(tree)
    leaves = tree_leaves(got)
    assert len(leaves) == len(want) == 5
    for g, w in zip(leaves, want):
        assert _bits(g) == _bits(w)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _ref_tree()
    port = load_pytree_from(tree, tmp_path)
    save_pytree(str(tmp_path / "pt"), port, extra={"k": [1, 2]})
    got, extra = jax_load(str(tmp_path / "pt"), tree)
    assert extra == {"k": [1, 2]}
    jax_save(str(tmp_path / "jx"), tree)
    own, _ = jax_load(str(tmp_path / "jx"), tree)
    for g, o in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(own)):
        assert g.dtype == o.dtype and g.shape == o.shape   # |V2 for bfloat16
        assert g.tobytes() == o.tobytes()
    for path in ("pt", "jx"):
        with open(tmp_path / path / "manifest.json") as f:
            assert json.load(f)["n_leaves"] == 5
    with open(tmp_path / "pt" / "manifest.json") as f, \
            open(tmp_path / "jx" / "manifest.json") as g:
        assert json.load(f)["treedef"] == json.load(g)["treedef"]


def load_pytree_from(tree, tmp_path):
    """The reference tree as the port's tensors, through a reference
    checkpoint."""
    jax_save(str(tmp_path / "seed"), tree)
    return load_pytree(str(tmp_path / "seed"), _like(tree))[0]


def test_load_checks_shapes_and_places_leaves(tmp_path):
    save_pytree(str(tmp_path / "a"), {"x": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path / "a"), {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "a"), {"x": torch.zeros(3),
                                          "y": torch.zeros(1)})
    got, _ = load_pytree(str(tmp_path / "a"),
                         {"x": torch.zeros(3, dtype=torch.float64)})
    assert got["x"].dtype == torch.float64 and got["x"].device.type == "cpu"
    meta, _ = load_pytree(str(tmp_path / "a"),
                          {"x": torch.empty(3, device="meta")})
    assert meta["x"].is_meta
    raw, _ = load_pytree(str(tmp_path / "a"), {"x": np.zeros(3, np.float32)})
    assert isinstance(raw["x"], np.ndarray)


def test_keep_and_tmp_directories_match_the_reference(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    jmgr = JaxManager(str(tmp_path / "jax"), keep=2)
    for step in (1, 5, 3, 9):
        mgr.save(step, tree)
        jmgr.save(step, {"w": np.arange(4, dtype=np.float32)})
    assert mgr.all_steps() == jmgr.all_steps() == [5, 9]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    # A crash mid-write leaves a .tmp directory: never listed, never read.
    os.makedirs(tmp_path / "port" / "step_0000000099.tmp")
    (tmp_path / "port" / "step_0000000099.tmp" / "manifest.json").write_text(
        "not json")
    assert mgr.latest_step() == 9
    got, _, step = mgr.restore({"w": torch.zeros(4)})
    assert step == 9 and torch.equal(got["w"], tree["w"])
    # The reference's manager reads the port's directory the same way.
    jgot, _, jstep = JaxManager(str(tmp_path / "port"), keep=2).restore(
        {"w": np.zeros(4, np.float32)})
    assert jstep == 9 and np.array_equal(jgot["w"], np.arange(4))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_async_checkpointer_waits_and_reraises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    ck = AsyncCheckpointer(mgr)
    tree = {"a": torch.randn(5, generator=torch.Generator().manual_seed(0)),
            "b": [torch.ones(2, dtype=torch.bfloat16)]}
    ck.save(1, tree)
    snapshot = tree["a"].clone()
    tree["a"].add_(1.0)                  # after save returns: not in step 1
    ck.wait()
    got, _, _ = mgr.restore(tree)
    assert torch.equal(got["a"], snapshot)
    assert torch.equal(got["b"][0], tree["b"][0])
    ck.save(2, tree, extra={"bad": object()})      # not JSON: fails in I/O
    with pytest.raises(TypeError):
        ck.wait()
    ck.wait()                                      # the error is reported once
    assert mgr.all_steps() == [1]


# --- synthetic streams and prefetch ------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.TokenStream(3, 9, 50, seed=4),
    lambda m: m.ImageStream(2, 5, 6, 10, seed=4),
    lambda m: m.DiffusionStream(2, 4, 3, n_classes=7, seed=4),
    lambda m: m.DiffusionStream(2, 4, 3, ctx_len=3, ctx_dim=5, seed=4),
], ids=["tokens", "images", "diffusion", "diffusion_ctx"])
def test_streams_bit_equal_to_reference(make):
    got, want = iter(make(syn)), iter(make(jsyn))
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes(), k


def test_prefetch_keeps_order_and_ends():
    items = [{"i": np.full(3, n, np.int32), "x": [np.float32(n)]}
             for n in range(7)]
    got = list(syn.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(got) == 7
    for n, g in enumerate(got):
        assert isinstance(g["i"], torch.Tensor) and g["i"].tolist() == [n] * 3
        assert float(g["x"][0]) == n
    assert list(syn.prefetch_to_device(iter([]), device="cpu")) == []


def test_default_device_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = {"w": cm.ParamSpec((2, 2), (None, None), "float32")}
    with pytest.raises(RuntimeError, match="CUDA"):
        cm.init_params(table, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cm.from_reference({"w": np.zeros((2, 2), np.float32)}, table)
    with pytest.raises(RuntimeError, match="CUDA"):
        cm.posemb_sincos_2d(2, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(syn.prefetch_to_device(iter([{"a": np.zeros(1)}])))
    leaves, _ = tree_flatten(cm.init_params(table, 0, device="cpu"))
    assert leaves[0].device.type == "cpu"
