"""PyTorch port, the optimizer (``repro_torch.optim``) held to the JAX
package's ``repro.optim`` on the CPU: ``adamw_init``, three
``adamw_update`` steps (the default ``ndim >= 2`` decay mask and a
path-keyed ``decay_mask``), ``global_norm``, ``clip_by_global_norm`` and
``cosine_schedule``, on the same seeded numpy pytrees (float32 leaves and
one bfloat16 leaf, keys out of sorted order).

Tolerance: each leaf within 1e-6 x max |reference leaf| (float32); the
bfloat16 params within one bfloat16 rounding step of the reference. The
``AdamWState`` of ``{"params", "opt"}`` flattens in the reference's order
(``.step``, then ``.mu[...]``, then ``.nu[...]``) and a checkpoint of it
saved by either package loads in the other bit for bit. The update writes
into the tensors it is given, and ``grad_scale`` equals clipping first
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro_torch import optim
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

from _torch_common import as_np

torch.set_num_threads(1)

RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    f = lambda *s: (scale * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"zeta": f(3, 4), "alpha": {"bias": f(5), "w": f(2, 3, 4)},
            "norm": f(6), "emb": f(4, 8).astype(np.float32)}


def _bf16_leaf(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _trees(seed, scale=1.0):
    """(jax tree, torch tree) of the same values; "emb" in bfloat16."""
    t = _np_tree(seed, scale)
    j = jax.tree.map(jnp.asarray, t)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), t)
    j["emb"], p["emb"] = _bf16_leaf(t["emb"])
    return j, p


def _assert_tree(got, want, rtol=RTOL):
    gl = tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w_np, g_np = as_np(w), as_np(g)
        assert g_np.shape == w_np.shape, path
        if isinstance(w, jax.Array) and w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, path
            # one bfloat16 step (8 bits of mantissa) of the value
            tol = np.abs(w_np) * 2.0 ** -7 + 1e-30
            assert (np.abs(g_np - w_np) <= tol).all(), path
        else:
            np.testing.assert_allclose(g_np, w_np, rtol=0, err_msg=path,
                                       atol=rtol * max(np.abs(w_np).max(), 1e-30))


def test_adamw_init_matches_reference():
    j, p = _trees(0)
    js, ts = jopt.adamw_init(j), optim.adamw_init(p)
    assert ts.step.dtype == torch.int32 and ts.step.shape == () and int(ts.step) == 0
    paths = [k for k, _ in tree_flatten_with_path(ts)[0]]
    assert paths == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(js)[0]]
    assert paths[0] == ".step" and paths[1].startswith(".mu[")
    for leaf in tree_leaves(ts.mu) + tree_leaves(ts.nu):
        assert leaf.dtype == torch.float32 and not leaf.any()
    _assert_tree(ts, js)


def _decay_b(path: str) -> bool:
    return "['alpha']" in path or path == "['norm']"


@pytest.mark.parametrize("mask", [None, _decay_b], ids=["default", "paths"])
def test_adamw_updates_match_reference(mask):
    j, p = _trees(1)
    js, ts = jopt.adamw_init(j), optim.adamw_init(p)
    jsched = jopt.cosine_schedule(3e-2, 2, 10)
    tsched = optim.cosine_schedule(3e-2, 2, 10)
    seen = []
    for k in range(3):
        jg, tg = _trees(10 + k, scale=0.3)
        jlr, tlr = jsched(js.step), tsched(ts.step)
        j, js = jopt.adamw_update(jg, js, j, jlr, decay_mask=mask)
        p_in = p
        p, ts = optim.adamw_update(tg, ts, p, tlr, decay_mask=mask)
        # consumed in place: the returned trees hold the given tensors
        assert all(a is b for a, b in zip(tree_leaves(p), tree_leaves(p_in)))
        seen.append(float(tlr))
        assert int(ts.step) == int(js.step) == k + 1
        assert ts.step.dtype == torch.int32
        _assert_tree(p, j)
        _assert_tree(ts.mu, js.mu)
        _assert_tree(ts.nu, js.nu)
    assert seen[0] == 0.0 and seen[1] > 0.0          # warmup from 0


def test_weight_decay_default_mask_is_ndim():
    """Only leaves with ndim >= 2 decay by default: with a zero gradient a
    1-d leaf stays and a 2-d one shrinks by lr * wd * p."""
    p = {"v": torch.ones(4), "m": torch.ones(2, 2)}
    st = optim.adamw_init(p)
    g = tree_map(torch.zeros_like, p)
    p, _ = optim.adamw_update(g, st, p, 0.5, weight_decay=0.1)
    assert torch.equal(p["v"], torch.ones(4))
    torch.testing.assert_close(p["m"], torch.full((2, 2), 0.95), rtol=0, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    j, p = _trees(2)
    jn, tn = jopt.global_norm(j), optim.global_norm(p)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    (jc, jn2), (tc, tn2) = (jopt.clip_by_global_norm(j, max_norm),
                            optim.clip_by_global_norm(p, max_norm))
    np.testing.assert_allclose(float(tn2), float(jn2), rtol=RTOL)
    for leaf in tree_leaves(tc):
        assert leaf.dtype == torch.float32      # promoted by the f32 scale
    _assert_tree(tc, jc)
    clipped = float(optim.global_norm(tc))
    np.testing.assert_allclose(clipped, min(float(jn), max_norm), rtol=1e-5)


def test_grad_scale_equals_clip_first():
    _, p = _trees(3)
    _, g = _trees(4)
    norm = optim.global_norm(g)
    scale = torch.clamp(0.5 / torch.clamp(norm, min=1e-12), max=1.0)
    clipped, _ = optim.clip_by_global_norm(g, 0.5)
    a, sa = optim.adamw_update(clipped, optim.adamw_init(p),
                               tree_map(torch.clone, p), 1e-2)
    b, sb = optim.adamw_update(g, optim.adamw_init(p),
                               tree_map(torch.clone, p), 1e-2, grad_scale=scale)
    for x, y in zip(tree_leaves((a, sa)), tree_leaves((b, sb))):
        assert torch.equal(x, y)


def test_update_walks_large_leaves_in_chunks(monkeypatch):
    """A leaf of more than ``CHUNK`` elements updates in pieces with the
    values of a one-piece update."""
    _, p = _trees(5)
    _, g = _trees(6)
    want, wst = optim.adamw_update(g, optim.adamw_init(p),
                                   tree_map(torch.clone, p), 1e-2)
    monkeypatch.setattr(optim.adamw, "CHUNK", 5)
    got, gst = optim.adamw_update(g, optim.adamw_init(p),
                                  tree_map(torch.clone, p), 1e-2)
    for x, y in zip(tree_leaves((got, gst)), tree_leaves((want, wst))):
        assert torch.equal(x, y)
    np.testing.assert_allclose(float(optim.global_norm(g)),
                               float(jopt.global_norm(jax.tree.map(
                                   lambda t: jnp.asarray(as_np(t)), g))),
                               rtol=RTOL)


@pytest.mark.parametrize("warmup,total", [(5, 200), (0, 10), (3, 3)])
def test_cosine_schedule_matches_reference(warmup, total):
    js, ts = jopt.cosine_schedule(3e-3, warmup, total), \
        optim.cosine_schedule(3e-3, warmup, total)
    for step in sorted({0, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                        total, total + 5}):
        got = ts(torch.tensor(step, dtype=torch.int32))
        want = js(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=1e-12, err_msg=str(step))
    assert float(ts(torch.tensor(0))) == (0.0 if warmup else np.float32(3e-3))


def _stepped_states():
    """A reference {"params", "opt"} after one update and the port's copy of
    the same values."""
    j, p = _trees(7)
    jg, tg = _trees(8)
    js = jopt.adamw_init(j)
    j, js = jopt.adamw_update(jg, js, j, 1e-2)
    p, ts = optim.adamw_update(tg, optim.adamw_init(p), p, 1e-2)
    return {"params": j, "opt": js}, {"params": p, "opt": ts}


def _bits(a) -> np.ndarray:
    """A leaf of either package, or a loaded ``|V2`` bfloat16 array, as
    float32 numpy."""
    if not isinstance(a, torch.Tensor) and np.asarray(a).dtype.kind == "V":
        return np.asarray(a).view(jnp.bfloat16).astype(np.float32)
    return as_np(a)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_adamw_state_checkpoint_across_packages(writer, tmp_path):
    jtree, ttree = _stepped_states()
    path = str(tmp_path / "ck")
    if writer == "port":
        save_pytree(path, ttree)
        got, _ = jax_load(path, jtree)
        assert isinstance(got["opt"], jopt.AdamWState)
        pairs = list(zip(tree_leaves(ttree), jax.tree.leaves(got)))
    else:
        jax_save(path, jtree)
        got, _ = load_pytree(path, tree_map(torch.empty_like, ttree))
        assert isinstance(got["opt"], optim.AdamWState)
        assert got["opt"].step.dtype == torch.int32
        pairs = list(zip(jax.tree.leaves(jtree), tree_leaves(got)))
    assert len(pairs) == len(tree_leaves(ttree)) == 2 * 5 + 1 + 5
    for a, b in pairs:
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(got["opt"].step) == 1
