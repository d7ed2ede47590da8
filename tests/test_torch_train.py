"""PyTorch port, the training path (``repro_torch.models.steps`` and
``repro_torch.launch.train``) held to the JAX package's on the CPU, at the
``smoke_config()`` sizes, the reference's params carried across by
``common.from_reference`` and the same seeded numpy batches in both.

Updates (new param - old param) are compared elementwise within 1e-4 x the
learning rates summed over the steps. Where the reference's |g| is below
1e-6 at some step, AdamW's division by ``sqrt(v) + eps`` can turn a
rounding difference into a sign: those elements are excepted, counted,
printed and asserted under 0.1 % of the leaf's. BatchNorm running stats
within 1e-4 x max(1, max |leaf|), losses within 1e-5 relative, the global
norm within 1e-4 relative. Cases: ResNet's BN cell of
``tests/test_models.py`` on 8 images (3 steps, warmup, the stat merge),
the LM cell of ``test_lm_train_step_reduces_loss`` (30 steps, the first 3
losses against the reference's), ``microbatches=2`` against the
reference's scan, EfficientNet (``remat`` recomputing its tail blocks
under autograd) on and off, and the train CLI with ``--device cpu
--smoke`` resuming from a checkpoint written by the port and from one
written by the reference's ``save_pytree``; after a resume the CLI's
losses are bit-equal to the train step run from the restored state on the
stream's first batches (a resumed run starts its data over, as the
reference's does)."""
import contextlib
import importlib
import io
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JaxManager
from repro.models import common as jcm
from repro.models import steps as jsteps
from repro_torch import configs, optim
from repro_torch.data import ImageStream, TokenStream
from repro_torch.launch import train
from repro_torch.models import common as cm
from repro_torch.models import efficientnet, steps
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

torch.set_num_threads(1)

UPDATE_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6
TINY_G = 1e-6
MAX_EXCEPTED = 1e-3


def _model(arch):
    """(jax module, port module, param table name) of a zoo id."""
    name = {"resnet-50": "resnet", "efficientnet-b7": "efficientnet",
            "llama3-8b": "transformer"}[arch]
    table = {"resnet": "resnet_param_table",
             "efficientnet": "efficientnet_param_table",
             "transformer": "lm_param_table"}[name]
    return (importlib.import_module(f"repro.models.{name}"),
            importlib.import_module(f"repro_torch.models.{name}"), table)


def _setup(arch, **cfg_kw):
    """(jax cfg, port cfg, reference params as numpy, port params (CPU),
    jax loss_fn, port loss_fn, port param table)."""
    jmod, tmod, table = _model(arch)
    jcfg = jconfigs.get_module(arch).smoke_config(**cfg_kw)
    tcfg = configs.get_module(arch).smoke_config(**cfg_kw)
    jt = getattr(jmod, table)(jcfg)
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jcm.init_params(k, jt))(jax.random.key(0)))
    ttable = getattr(tmod, table)(tcfg)
    tp = cm.from_reference(jp, ttable, device="cpu")
    return (jcfg, tcfg, jp, tp, jmod.make_loss_fn(jcfg),
            tmod.make_loss_fn(tcfg), ttable)


def _images(n, res, n_classes, seed):
    r = np.random.default_rng(seed)
    return {"images": r.random((n, res, res, 3)).astype(np.float32),
            "labels": (np.arange(n) % n_classes).astype(np.int32)}


def _lm_batch(b, s, vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _both(batch):
    return (jax.tree.map(jnp.asarray, batch),
            tree_map(lambda a: torch.from_numpy(a.copy()), batch))


def _port_state(jpar, jst, table):
    """The port's copy of a reference ``(params, AdamWState)``."""
    host = lambda t: tree_map(lambda a: torch.from_numpy(np.array(a)),  # noqa: E731
                              jax.tree.map(np.asarray, t))
    return (cm.from_reference(jax.tree.map(np.asarray, jpar), table, device="cpu"),
            optim.AdamWState(step=torch.tensor(int(jst.step), dtype=torch.int32),
                             mu=host(jst.mu), nu=host(jst.nu)))


def _check_updates(p0, got, want, unsure, lr, label):
    """Each non-BN-stat leaf's update (from ``p0``) within UPDATE_RTOL x
    ``lr`` plus one float32 unit in the last place of the new value,
    except where ``unsure`` (see :func:`_unsure`) says the gradient
    allows more; those elements are counted and printed, and the ones
    whose reference |g| is below TINY_G stay under MAX_EXCEPTED of all.
    BN running stats within 1e-4 x max(1, max |leaf|)."""
    gl = tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    tiny_n = drift_n = drift_all = total = 0
    masks = jax.tree.leaves(unsure, is_leaf=lambda x: isinstance(x, tuple))
    for (path, g), (_, w), p, (tiny, drift) in zip(gl, wl, jax.tree.leaves(p0),
                                                   masks):
        g, w, p = g.numpy(), np.asarray(w), np.asarray(p)
        assert g.shape == w.shape and np.isfinite(g).all(), path
        if path.endswith(("['mean']", "['var']")):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()),
                err_msg=f"{label} {path}")
            continue
        # one float32 rounding of the new value on top: at lr 1e-3 a
        # unit in the last place of a BN scale near 1 exceeds 1e-4 x lr
        tol = UPDATE_RTOL * lr + np.spacing(np.abs(w).astype(np.float32))
        bad = np.abs((g - p) - (w - p)) > tol
        assert not (bad & ~tiny & ~drift).any(), (
            label, path, np.abs((g - p) - (w - p)).max())
        tiny_n += int((bad & tiny).sum())
        drift_n += int((bad & drift & ~tiny).sum())
        drift_all += int((drift & ~tiny).sum())
        total += g.size
    print(f"{label}: of {total} elements, {tiny_n} excepted with reference "
          f"|g| < {TINY_G} and {drift_n} (of {drift_all} whose gradients "
          f"differ by more than {UPDATE_RTOL} relative) with the gradient's "
          f"difference, their update off by more than {UPDATE_RTOL} x lr")
    assert tiny_n <= MAX_EXCEPTED * total, label


def _unsure(want_grads, got_grads):
    """Per element, ``(tiny, drift)``: whether the update may differ by
    more than UPDATE_RTOL x lr because the gradient does. ``tiny``: the
    reference's |g| is below TINY_G, where AdamW's division by ``sqrt(v) +
    eps`` can turn a rounding difference into a sign. ``drift``: the
    port's gradient, held within the gradients' tolerance of the
    reference's, differs from it by more than UPDATE_RTOL relative;
    AdamW's update is a ratio of gradient sums, so a relative gradient
    difference reaches it at up to its own size. Checks the gradients
    too: each leaf within GRAD_RTOL x its max |g|."""
    def one(w, g):
        w, g = np.asarray(w), g.numpy()
        err = np.abs(g - w)
        assert err.max() <= GRAD_RTOL * np.abs(w).max() + 1e-30
        return (np.abs(w) < TINY_G, err > UPDATE_RTOL * np.abs(w))
    return jax.tree.map(one, want_grads, got_grads)


def test_resnet_bn_stats_update_and_merge():
    """Three steps (warmup: lr 0 first), each step of the port run from the
    reference's state and held to the reference's step; then the port's own
    three-step run: BN stats moved, step 3, losses within 1e-4 relative of
    the reference's run."""
    jcfg, tcfg, jp, tp, jloss, tloss, table = _setup("resnet-50")
    jb, tb = _both(_images(8, jcfg.img_res, jcfg.n_classes, seed=1))
    sched = (jopt.cosine_schedule(1e-3, 5, 100), optim.cosine_schedule(1e-3, 5, 100))
    jstep = jax.jit(jsteps.make_train_step(jloss, sched[0], has_bn=True))
    jgrad = jax.jit(jax.grad(jloss, has_aux=True))
    tstep = steps.make_train_step(tloss, sched[1], has_bn=True)
    jpar, jst = jax.tree.map(jnp.asarray, jp), jopt.adamw_init(jp)
    own, own_opt = tree_map(torch.clone, tp), optim.adamw_init(tp)
    before = tp["stem_bn"]["mean"].clone()
    lrs, jlosses, own_losses = [], [], []
    for k in range(3):
        p0 = jax.tree.map(np.asarray, jpar)
        tpar, topt = _port_state(jpar, jst, table)
        tiny = _unsure(jgrad(jpar, jb)[0],
                       steps.value_and_grad(tloss, tpar, tb)[2])
        jpar, jst, jm = jstep(jpar, jst, jb)
        tpar, topt, tm = tstep(tpar, topt, tb)
        lrs.append(float(tm["lr"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr", "nll"]
        assert int(topt.step) == k + 1
        assert not any(t.requires_grad for t in tree_leaves(tpar))
        _check_updates(p0, tpar, jpar, tiny, lrs[-1], f"resnet step {k + 1}")
        own, own_opt, m = tstep(own, own_opt, tb)
        jlosses.append(float(jm["loss"]))
        own_losses.append(float(m["loss"]))
    assert lrs[0] == 0.0 and lrs[1] > 0.0 and int(own_opt.step) == 3
    assert not torch.equal(before, own["stem_bn"]["mean"]), "BN stats must move"
    np.testing.assert_allclose(own_losses, jlosses, rtol=1e-4)


def test_lm_train_step_reduces_loss():
    jcfg, tcfg, jp, tp, jloss, tloss, _ = _setup("llama3-8b")
    batch = _lm_batch(4, 16, tcfg.vocab, seed=1)
    jb, tb = _both(batch)
    jstep = jax.jit(jsteps.make_train_step(jloss, jopt.cosine_schedule(3e-3, 5, 200)))
    tstep = steps.make_train_step(tloss, optim.cosine_schedule(3e-3, 5, 200))
    jpar, jst = jax.tree.map(jnp.asarray, jp), jopt.adamw_init(jp)
    want = []
    for _ in range(3):
        jpar, jst, m = jstep(jpar, jst, jb)
        want.append(float(m["loss"]))
    params, opt = tp, optim.adamw_init(tp)
    losses = []
    for _ in range(30):
        params, opt, metrics = tstep(params, opt, tb)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[:3], want, rtol=1e-5)
    assert losses[-1] < losses[0] * 0.7
    assert int(opt.step) == 30 and opt.step.dtype == torch.int32


def test_microbatches_match_reference_scan():
    jcfg, tcfg, jp, tp, jloss, tloss, _ = _setup("llama3-8b")
    jb, tb = _both(_lm_batch(4, 16, tcfg.vocab, seed=2))
    sched = (jopt.cosine_schedule(1e-3, 0, 10), optim.cosine_schedule(1e-3, 0, 10))
    jstep = jax.jit(jsteps.make_train_step(jloss, sched[0], microbatches=2))
    tstep = steps.make_train_step(tloss, sched[1], microbatches=2)
    g = jax.jit(jax.grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, jp), jb)[0]
    tiny = _unsure(g, steps.value_and_grad(tloss, tp, tb)[2])
    halves = [tloss(tp, tree_map(lambda x: x[i:i + 2], tb))[1]["nll"]
              for i in (0, 2)]
    jpar, _, jm = jstep(jax.tree.map(jnp.asarray, jp), jopt.adamw_init(jp), jb)
    tpar, topt, tm = tstep(tp, optim.adamw_init(tp), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(topt.step) == 1
    _check_updates(jp, tpar, jpar, tiny, 1e-3, "llama3 microbatches=2")
    # the loss is the microbatches' mean; the other metrics the last one's
    assert float(tm["nll"]) == float(halves[1]) != float(halves[0])
    np.testing.assert_allclose(float(tm["loss"]), float(sum(halves)) / 2,
                               rtol=1e-6)


def test_microbatches_with_bn_raise():
    with pytest.raises(ValueError, match="BN"):
        steps.make_train_step(lambda p, b: (0, {}), lambda s: 0.0,
                              has_bn=True, microbatches=2)


def test_efficientnet_remat_under_autograd():
    """EfficientNet's tail blocks recompute under autograd
    (``torch.utils.checkpoint``): remat on and off give the same loss,
    gradients and new BN stats, the gradients are the reference's, and a
    train step (BN merge) runs. A gradient leaf is held within 1e-4 x its
    own max |g| plus GRAD_FLOOR x the tree's largest |g|: the projection
    BN biases feed a training-mode BN, so their true gradient is 0 and
    both packages return float32 rounding (the reference's below 2e-6)."""
    jcfg, tcfg, jp, tp, jloss, tloss, _ = _setup("efficientnet-b7")
    off = configs.get_module("efficientnet-b7").smoke_config(remat=False)
    jb, tb = _both(_images(8, 32, jcfg.n_classes, seed=3))
    jg = jax.jit(jax.grad(jloss, has_aux=True))(jax.tree.map(jnp.asarray, jp), jb)[0]
    assert tcfg.remat and not off.remat
    outs = {}
    for name, cfg in (("on", tcfg), ("off", off)):
        loss, metrics, grads = steps.value_and_grad(
            efficientnet.make_loss_fn(cfg), tp, tb)
        outs[name] = (loss, grads, metrics["bn_params"])
    assert torch.equal(outs["on"][0], outs["off"][0])
    for a, b in zip(tree_leaves(outs["on"][1:]), tree_leaves(outs["off"][1:])):
        assert torch.equal(a, b)
    top = max(float(np.abs(np.asarray(w)).max()) for w in jax.tree.leaves(jg))
    for (path, g), w in zip(tree_flatten_with_path(outs["on"][1])[0],
                            jax.tree.leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, err_msg=path,
            atol=GRAD_RTOL * np.abs(w).max() + GRAD_FLOOR * top)
    step = steps.make_train_step(tloss, optim.cosine_schedule(1e-3, 0, 10),
                                 has_bn=True)
    before = tp["stem_bn"]["var"].clone()
    params, opt, m = step(tp, optim.adamw_init(tp), tb)
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1
    assert not torch.equal(before, params["stem_bn"]["var"])


# --- the train CLI --------------------------------------------------------------

CLI = {"resnet-50": ["--batch", "8"],
       "llama3-8b": ["--batch", "4", "--seq-len", "16"]}


def _cli(arch, ck, steps_, on_resume=None):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", str(steps_),
            "--ckpt-every", "3", "--ckpt-dir", str(ck), "--log-every", "1",
            *CLI[arch]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.run(argv, on_resume=on_resume)
    return res, out.getvalue()


def _first_batches(arch, n):
    mod = configs.get_module(arch)
    cfg = mod.smoke_config()
    if mod.FAMILY == "lm":
        stream = TokenStream(4, 16, cfg.vocab)
    else:
        stream = ImageStream(8, cfg.img_res, cfg.img_res, cfg.n_classes)
    return [tree_map(torch.from_numpy, b) for b in itertools.islice(stream, n)]


def _replay(arch, state, start, total):
    """The port's train step from ``state`` on the stream's first batches,
    with the CLI's schedule: the losses a resumed CLI must print."""
    _, _, loss, _, has_bn = train.build(arch, True, 1, 16, 0)
    step = steps.make_train_step(
        loss, optim.cosine_schedule(1e-3, max(total // 10, 1), total),
        has_bn=has_bn)
    params, opt = state["params"], state["opt"]
    out = []
    for b in _first_batches(arch, total - start):
        params, opt, m = step(params, opt, b)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("arch", list(CLI))
def test_train_cli_resumes_from_its_checkpoint(arch, tmp_path):
    first, log = _cli(arch, tmp_path, 3)
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert "resumed" not in log and "step 3:" in log
    saved = tree_map(torch.clone, {"params": first["params"], "opt": first["opt"]})
    seen = {}

    def on_resume(restored, step):
        seen["step"] = step
        seen["state"] = tree_map(torch.clone, restored)
        for a, b in zip(tree_leaves(restored), tree_leaves(saved)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    second, log = _cli(arch, tmp_path, 5, on_resume)
    assert "resumed from step 3" in log and seen["step"] == 3
    assert int(seen["state"]["opt"].step) == 3 and int(second["opt"].step) == 5
    assert second["start"] == 3 and len(second["losses"]) == 2
    assert np.isfinite(second["losses"]).all()
    assert second["losses"] == _replay(arch, seen["state"], 3, 5)


@pytest.mark.parametrize("arch", list(CLI))
def test_train_cli_resumes_from_a_reference_checkpoint(arch, tmp_path):
    jmod, _, table = _model(arch)
    jcfg = jconfigs.get_module(arch).smoke_config()
    jt = getattr(jmod, table)(jcfg)
    jp = jax.jit(lambda k: jcm.init_params(k, jt))(jax.random.key(5))
    r = np.random.default_rng(5)
    mom = lambda p: jnp.asarray(np.abs(r.standard_normal(p.shape)) * 1e-3,  # noqa: E731
                                jnp.float32)
    jstate = {"params": jp, "opt": jopt.AdamWState(
        step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(mom, jp),
        nu=jax.tree.map(mom, jp))}
    JaxManager(str(tmp_path), keep=3).save(3, jstate)
    seen = {}

    def on_resume(restored, step):
        seen["state"] = tree_map(torch.clone, restored)
        for a, b in zip(tree_leaves(restored), jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    res, log = _cli(arch, tmp_path, 5, on_resume)
    assert "resumed from step 3" in log and res["start"] == 3
    assert int(res["opt"].step) == 5
    assert res["losses"] == _replay(arch, seen["state"], 3, 5)


def test_train_cli_needs_a_card_or_the_cpu_flag(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--arch", "resnet-50", "--smoke", "--steps", "1"])
    for arch in ("dit-l2", "unet-sdxl"):
        with pytest.raises(SystemExit, match="make_train_step"):
            train.build(arch, True, 2, 16, 0)
