"""PyTorch port, the diffusion family (``repro_torch.models.dit`` and
``repro_torch.models.unet`` with their ``configs``) held to the JAX
package's on the CPU, at each id's ``smoke_config()`` (the U-Net's at
``ch=64``, see below): the reference's own
``init_params(jax.random.key(0), table)`` carried across by
``common.from_reference``, the same seeded numpy inputs through both (the
JAX side jitted, as ``tests/test_models.py`` runs it).

Both models zero-init their adaLN/output leaves (``ada_w``, ``ada_b``,
``final_*``; ``proj_out``, ``conv_out``), which makes the output 0 and
every comparison of it empty; the cases fill those leaves with seeded
values (the same numpy arrays in both packages), except where a case
checks that the published init predicts exactly 0. The bfloat16 params
are the float32 ones rounded (``smoke_config()`` with ``dtype=
"bfloat16"``, the published dtype).

The U-Net runs at ``ch=64``, not the smoke ``ch=16``: its GroupNorms
have 32 groups, and at 16 or 32 channels each group holds one channel,
which removes the time embedding's per-channel add in every res block
and with it the whole conditioning path (``t_mlp1``, ``t_mlp2``,
``pool_proj``, ``t_proj``, ``t_proj_b``). At 64 and 128 channels each
group holds two or four, so the timestep and ``pooled`` reach the output
and every leaf has a gradient.

Tolerances. Float32: outputs and sampled latents within 1e-5 x max |out|
of the reference's, the loss within 1e-6 relative, each gradient leaf
within 1e-4 x its max |g|, one train
step's update by ``tests/test_torch_train.py``'s rule (1e-4 x lr plus one
float32 rounding, with its counted exceptions). Bfloat16: forwards and losses,
outputs within BF16_RTOL = 4e-2 x max |out| of the reference's and the
loss within 1e-2 relative -- the two packages round the bfloat16
products and elementwise results at different points, eight bits of
mantissa a rounding. A bfloat16 sample step multiplies those roundings
twice: classifier-free guidance, ``eps_u + g * (eps_c - eps_u)``, by up
to |1 - g| + |g| (14 at the U-Net's g = 7.5, 7 at DiT's 4.0), and the
DDIM step's division by sqrt(abar(t)) by up to 640 near t = 999 (the
bfloat16 steps draw t below 500, a gain of at most 1.42; the float32
ones up to 999). Two
bfloat16 roundings of it can then differ by more than either differs
from the exact step, so each is held to an oracle instead, the
reference's float32 sample step on the bfloat16 params (cast to
float32) and the same inputs: the port's step within BF16_RTOL x max
|oracle| of it, and no further from it than 1.5 times the reference's
own bfloat16 step. In the
port alone: ``remat`` on gives gradients bit-equal to off, and the
query-chunked attention equals one chunk within 1e-6 x max |out| (a
whole model's output, through every layer, within 1e-5). ``build_plan``
and the param tables (tree, shapes, axes, dtypes, inits at the published
and smoke configs) equal the reference's exactly; the tables are
compared as ``meta`` tensors, nothing allocated."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JaxManager
from repro.models import common as jcm
from repro.models import dit as JD
from repro.models import steps as jsteps
from repro.models import unet as JU
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import common as cm
from repro_torch.models import dit as D
from repro_torch.models import steps
from repro_torch.models import unet as U
from repro_torch.tree import tree_flatten, tree_flatten_with_path, tree_leaves

from test_torch_train import _check_updates, _unsure

torch.set_num_threads(1)

F32_RTOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
BF16_RTOL = 4e-2
BF16_LOSS_RTOL = 1e-2
BF16_T_MAX = 500
CHUNK_RTOL = 1e-6
ARCHS = ("dit-l2", "unet-sdxl")
MODELS = {"dit-l2": (JD, D, "dit_param_table"),
          "unet-sdxl": (JU, U, "unet_param_table")}
ZERO_INIT = ("ada_w", "ada_b", "final_ada_w", "final_ada_b", "final_proj",
             "proj_out", "conv_out")
UNET_CH = 64                             # see above
SCHED = 1e-3, 0, 10                      # cosine_schedule(lr, warmup, total)


def _cfgs(arch, dtype="float32"):
    """The (reference, port) configs the cases run: ``smoke_config()`` in
    ``dtype``, the U-Net's at ``ch=UNET_CH``."""
    kw = {"dtype": dtype, **({"ch": UNET_CH} if arch == "unet-sdxl" else {})}
    return tuple(dataclasses.replace(reg.get_module(arch).smoke_config(), **kw)
                 for reg in (jconfigs, configs))


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    """The reference's float32 smoke params, as numpy (one jit an arch)."""
    jmod, _, table = MODELS[arch]
    jt = getattr(jmod, table)(_cfgs(arch)[0])
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jcm.init_params(k, jt))(jax.random.key(0)))


def _fill_zero_init(jp, seed):
    """``jp`` with its zero-init leaves (ZERO_INIT) drawn from a seeded
    normal, scaled by 1/sqrt(rows) (0.1 for vectors)."""
    r = np.random.default_rng(seed)

    def one(path, a):
        if jax.tree_util.keystr(path).split("'")[-2] not in ZERO_INIT:
            return a
        scale = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[-2])
        return (r.standard_normal(a.shape) * scale).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(one, jp)


@pytest.fixture(scope="module")
def zoo():
    """By (arch, dtype, filled): (reference params as numpy, port params on
    the CPU, jax cfg, port cfg), made once."""
    cache = {}

    def get(arch, dtype="float32", filled=True):
        key = (arch, dtype, filled)
        if key not in cache:
            _, tmod, table = MODELS[arch]
            jcfg, tcfg = _cfgs(arch, dtype)
            jp = _ref_init(arch)
            if filled:
                jp = _fill_zero_init(jp, 7)
            jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jp)
            tp = cm.from_reference(jp, getattr(tmod, table)(tcfg), device="cpu")
            cache[key] = (jp, tp, jcfg, tcfg)
        return cache[key]
    return get


@functools.lru_cache(maxsize=None)
def _jitted(arch, dtype, kind, img_res=None):
    """The reference's jitted ``forward``, ``sample``, ``loss`` or
    ``value_and_grad`` of the smoke config in ``dtype``, made once."""
    jmod = MODELS[arch][0]
    jcfg = _cfgs(arch, dtype)[0]
    if kind == "forward":
        return jax.jit(jmod.make_forward(jcfg, img_res=img_res))
    if kind == "sample":
        return jax.jit(jmod.make_sample_step(jcfg))
    if kind == "loss":
        return jax.jit(jmod.make_loss_fn(jcfg))
    return jax.jit(jax.value_and_grad(jmod.make_loss_fn(jcfg), has_aux=True))


def _close(got, want, rtol, msg=""):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, msg
    assert np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _rtol(dtype):
    return F32_RTOL if dtype == "float32" else BF16_RTOL


def _inputs(arch, cfg, b, seed, res=None, t_max=1000):
    """Seeded numpy inputs of a forward / sample step / loss: latents,
    timesteps in [1, t_max), noise, and the labels (DiT) or context and
    pooled (U-Net). DiT's labels run past both ends of the class table and
    hit the CFG null class."""
    r = np.random.default_rng(seed)
    lat = (res or cfg.img_res) // 8
    out = {"latents": r.standard_normal((b, lat, lat, 4)).astype(np.float32),
           "timesteps": r.integers(1, t_max, (b,)).astype(np.int32),
           "noise": r.standard_normal((b, lat, lat, 4)).astype(np.float32)}
    if arch == "dit-l2":
        labels = [3, -2, cfg.n_classes + 4, cfg.n_classes]
        out["labels"] = np.asarray((labels * b)[:b], np.int32)
    else:
        out["context"] = r.standard_normal((b, cfg.ctx_len, cfg.ctx_dim)
                                           ).astype(np.float32)
        out["pooled"] = r.standard_normal((b, cfg.ctx_dim)).astype(np.float32)
    return out


def _both(x):
    return (jax.tree.map(jnp.asarray, x),
            {k: torch.from_numpy(v.copy()) for k, v in x.items()})


def _cond(arch, batch):
    return ((batch["labels"],) if arch == "dit-l2"
            else (batch["context"], batch["pooled"]))


@functools.lru_cache(maxsize=None)
def _train_batch(arch):
    return _inputs(arch, _cfgs(arch)[1], 2, seed=5)


@pytest.fixture(scope="module")
def ref_grads(zoo):
    """By arch: the reference's ``((loss, metrics), grads)`` on the filled
    float32 params and ``_train_batch(arch)``, computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jp = zoo(arch)[0]
            jb = jax.tree.map(jnp.asarray, _train_batch(arch))
            cache[arch] = _jitted(arch, "float32", "grad")(jp, jb)
        return cache[arch]
    return get


# --- plans and tables ------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_build_plan_matches_reference(which):
    jcfg = getattr(jconfigs.get_module("unet-sdxl"), which)()
    tcfg = getattr(configs.get_module("unet-sdxl"), which)()
    for got, want in zip(U.build_plan(tcfg), JU.build_plan(jcfg)):
        assert [dataclasses.astuple(b) for b in got] == \
            [dataclasses.astuple(b) for b in want]


def test_unet_plan_stack_balances():
    down, mid, up = U.build_plan(configs.get_module("unet-sdxl").config())
    pushes = 1 + sum(1 for b in down if b.kind in ("res", "down"))
    pops = sum(1 for b in up if b.kind == "res")
    assert pushes == pops
    assert sum(1 for b in mid if b.kind == "attn") == 1


@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tables_match_reference(arch, which):
    jmod, tmod, table = MODELS[arch]
    jcfg = getattr(jconfigs.get_module(arch), which)()
    tcfg = getattr(configs.get_module(arch), which)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jt, tt = getattr(jmod, table)(jcfg), getattr(tmod, table)(tcfg)
    is_j = lambda s: isinstance(s, jcm.ParamSpec)  # noqa: E731
    jleaves = jax.tree_util.tree_flatten_with_path(jt, is_leaf=is_j)[0]
    tleaves = tree_flatten_with_path(tt)[0]
    assert [p for p, _ in tleaves] == [jax.tree_util.keystr(p)
                                       for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert (t.shape, t.axes, t.init, t.scale) == \
            (tuple(j.shape), tuple(j.axes), j.init, j.scale), path
        assert cm.dtype_name(t.dtype) == jnp.dtype(j.dtype).name, path
    metas = tree_flatten(cm.param_shapes(tt))[0]
    jshapes = jax.tree.leaves(jcm.param_shapes(jt))
    assert all(m.is_meta for m in metas)
    assert [(tuple(m.shape), cm.dtype_name(m.dtype)) for m in metas] == \
        [(tuple(s.shape), jnp.dtype(s.dtype).name) for s in jshapes]
    assert cm.param_count(tt) == jcm.param_count(jt)
    if which == "config":
        assert cm.param_count(tt) == {"dit-l2": 457_616_384,
                                      "unet-sdxl": 2_580_667_200}[arch]


# --- forwards and sample steps ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("img_res", [None, 64])
def test_dit_forward_matches_reference(img_res, dtype, zoo):
    jp, tp, _, tcfg = zoo("dit-l2", dtype)
    jb, tb = _both(_inputs("dit-l2", tcfg, 4, seed=1, res=img_res))
    want = _jitted("dit-l2", dtype, "forward", img_res)(
        jp, jb["latents"], jb["timesteps"], jb["labels"])
    got = D.make_forward(tcfg, img_res=img_res)(
        tp, tb["latents"], tb["timesteps"], tb["labels"])
    r = (img_res or tcfg.img_res) // 8
    assert tuple(got.shape) == (4, r, r, 8) and got.dtype == tcfg.torch_dtype
    _close(got, want, _rtol(dtype), "dit forward")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_forward_matches_reference(dtype, zoo):
    jp, tp, _, tcfg = zoo("unet-sdxl", dtype)
    jb, tb = _both(_inputs("unet-sdxl", tcfg, 2, seed=3))
    want = _jitted("unet-sdxl", dtype, "forward")(
        jp, jb["latents"], jb["timesteps"], jb["context"], jb["pooled"])
    got = U.make_forward(tcfg)(
        tp, tb["latents"], tb["timesteps"], tb["context"], tb["pooled"])
    assert tuple(got.shape) == tuple(tb["latents"].shape)
    assert got.dtype == tcfg.torch_dtype
    _close(got, want, _rtol(dtype), "unet forward")


def test_unet_conditioning_matches_reference(zoo):
    """The timestep and ``pooled`` reach the output: the same latents and
    context at two timesteps and two ``pooled``, each forward against the
    reference, and changing either moves the output by more than 100 times
    the tolerance."""
    jp, tp, _, tcfg = zoo("unet-sdxl")
    x = _inputs("unet-sdxl", tcfg, 2, seed=11)
    r = np.random.default_rng(12)
    ts = (np.asarray([20, 20], np.int32), np.asarray([900, 900], np.int32))
    pools = (x["pooled"], r.standard_normal(x["pooled"].shape).astype(np.float32))
    fwd, jfwd = U.make_forward(tcfg), _jitted("unet-sdxl", "float32", "forward")
    outs = {}
    for i, t in enumerate(ts):
        for j, pooled in enumerate(pools):
            jb, tb = _both(dict(x, timesteps=t, pooled=pooled))
            want = jfwd(jp, jb["latents"], jb["timesteps"], jb["context"],
                        jb["pooled"])
            outs[i, j] = fwd(tp, tb["latents"], tb["timesteps"], tb["context"],
                             tb["pooled"])
            _close(outs[i, j], want, F32_RTOL, f"unet t {t} pooled {j}")
    scale = float(outs[0, 0].abs().max())
    for a, b in (((0, 0), (1, 0)), ((0, 0), (0, 1))):
        moved = float((outs[a] - outs[b]).abs().max())
        assert moved > 100 * F32_RTOL * scale, (a, b, moved, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sample_step_matches_reference(arch, dtype, zoo):
    jp, tp, _, tcfg = zoo(arch, dtype)
    x = _inputs(arch, tcfg, 2, seed=2,
                t_max=1000 if dtype == "float32" else BF16_T_MAX)
    x["t_next"] = np.maximum(x["timesteps"] - 250, 0).astype(np.int32)
    jb, tb = _both(x)
    args = (jb["latents"], jb["timesteps"], jb["t_next"], *_cond(arch, jb))
    want = _jitted(arch, dtype, "sample")(jp, *args)
    got = MODELS[arch][1].make_sample_step(tcfg)(
        tp, tb["latents"], tb["timesteps"], tb["t_next"], *_cond(arch, tb))
    assert got.dtype == torch.float32 and got.shape == tb["latents"].shape
    if dtype == "float32":
        _close(got, want, F32_RTOL, f"{arch} sample step")
        return
    # Bfloat16: both steps against the float32 oracle (see the docstring).
    oracle = np.asarray(_jitted(arch, "float32", "sample")(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), *args))
    _close(got, oracle, BF16_RTOL, f"{arch} bf16 sample step vs oracle")
    port, ref = got.numpy(), np.asarray(want, np.float32)
    port_err, ref_err = np.abs(port - oracle).max(), np.abs(ref - oracle).max()
    print(f"{arch} bf16 sample step, max |err| against the oracle: port "
          f"{port_err:.4f}, reference jit {ref_err:.4f}; port against the "
          f"reference {np.abs(port - ref).max():.4f}; max |oracle| "
          f"{np.abs(oracle).max():.4f}")
    assert port_err <= 1.5 * ref_err, (arch, port_err, ref_err)


@pytest.mark.parametrize("arch", ARCHS)
def test_published_init_predicts_zero(arch, zoo):
    """Both models zero-init their output projection: the first prediction
    is exactly 0, so the first loss is mean(noise^2), in both packages."""
    jp, tp, _, tcfg = zoo(arch, filled=False)
    x = _inputs(arch, tcfg, 2, seed=4)
    jb, tb = _both(x)
    out = MODELS[arch][1].make_forward(tcfg)(
        tp, tb["latents"], tb["timesteps"], *_cond(arch, tb))
    assert not out.any()
    loss, _ = MODELS[arch][1].make_loss_fn(tcfg)(tp, tb)
    want, _ = _jitted(arch, "float32", "loss")(jp, jb)
    np.testing.assert_allclose(float(loss), np.mean(np.square(
        x["noise"].astype(np.float64))), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)


# --- loss, gradients, one train step ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, zoo, ref_grads):
    """Float32: the loss and every gradient leaf; bfloat16: the loss."""
    jp, tp, _, tcfg = zoo(arch, dtype)
    tloss = MODELS[arch][1].make_loss_fn(tcfg)
    jb, tb = _both(_train_batch(arch))
    if dtype != "float32":
        want, wm = _jitted(arch, dtype, "loss")(jp, jb)
        got, metrics = tloss(tp, tb)
        assert got.dtype == torch.float32 and sorted(metrics) == sorted(wm)
        np.testing.assert_allclose(float(got), float(want), rtol=BF16_LOSS_RTOL)
        return
    (wl, wm), wg = ref_grads(arch)
    loss, metrics, grads = steps.value_and_grad(tloss, tp, tb)
    assert sorted(metrics) == sorted(wm) == ["mse"]
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(wl), rtol=LOSS_RTOL)
    gl = tree_flatten_with_path(grads)[0]
    wl_ = jax.tree_util.tree_flatten_with_path(wg)[0]
    assert [p for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl_]
    for (path, g), (_, w) in zip(gl, wl_):
        _close(g, w, GRAD_RTOL, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, zoo, ref_grads):
    """One step of the port's ``make_train_step`` against the reference's
    update of its own gradients: the body of its ``make_train_step``
    (``clip_by_global_norm``, ``cosine_schedule``, ``adamw_update``),
    jitted, run on the reference's jitted ``value_and_grad`` (for DiT also
    its whole jitted ``make_train_step``, which agrees with it)."""
    jp, tp, jcfg, tcfg = zoo(arch)
    jmod, tmod, table = MODELS[arch]
    jb, tb = _both(_train_batch(arch))
    (wl, _), wg = ref_grads(arch)
    tloss = tmod.make_loss_fn(tcfg)
    unsure = _unsure(wg, steps.value_and_grad(tloss, tp, tb)[2])
    jst = jopt.adamw_init(jp)

    @jax.jit
    def update(grads, params):
        clipped, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        lr = jopt.cosine_schedule(*SCHED)(jst.step)
        return jopt.adamw_update(clipped, jst, params, lr,
                                 weight_decay=0.1)[0], gnorm, lr

    jpar, gnorm, lr = update(wg, jax.tree.map(jnp.asarray, jp))
    if arch == "dit-l2":
        whole, _, jm = jax.jit(jsteps.make_train_step(
            jmod.make_loss_fn(jcfg), jopt.cosine_schedule(*SCHED)))(
                jax.tree.map(jnp.asarray, jp), jst, jb)
        np.testing.assert_allclose(float(jm["loss"]), float(wl), rtol=LOSS_RTOL)
        for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(jpar)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-4 * float(lr))
    params = cm.from_reference(jp, getattr(tmod, table)(tcfg), device="cpu")
    tpar, topt, tm = steps.make_train_step(tloss, optim.cosine_schedule(*SCHED))(
        params, optim.adamw_init(params), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(gnorm), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(lr), rtol=1e-6)
    assert int(topt.step) == 1 and sorted(tm) == ["grad_norm", "loss", "lr", "mse"]
    _check_updates(jp, tpar, jpar, unsure, float(lr), f"{arch} train step")


# --- the port alone: remat, chunked attention, checkpoints -------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_gradients(arch, zoo):
    _, tp, _, tcfg = zoo(arch)
    tmod = MODELS[arch][1]
    on = dataclasses.replace(tcfg, remat=True)
    _, tb = _both(_inputs(arch, tcfg, 2, seed=8))
    outs = [steps.value_and_grad(tmod.make_loss_fn(c), tp, tb) for c in (on, tcfg)]
    assert on.remat and not tcfg.remat
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        assert torch.equal(a, b)


def test_chunked_attention_equals_one_chunk(monkeypatch):
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(2, n, 3, 8, generator=g) for n in (37, 29, 29))
    whole = cm.full_attention(q, k, v)
    for rows in (1, 5, 36):
        monkeypatch.setattr(cm, "ATTN_SCORE_BYTES", 2 * 3 * 29 * 4 * rows)
        got = cm.full_attention(q, k, v)
        err = float((got - whole).abs().max())
        assert err <= CHUNK_RTOL * float(whole.abs().max()), (rows, err)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert float((whole - ref).abs().max()) <= CHUNK_RTOL * float(ref.abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_models_chunked_equal_unchunked(arch, zoo, monkeypatch):
    """A score budget of one byte: every attention of the forward runs one
    query row a chunk, and the output equals the one-chunk forward within
    F32_RTOL (the chunks' roundings pass through every later layer)."""
    _, tp, _, tcfg = zoo(arch)
    _, tb = _both(_inputs(arch, tcfg, 2, seed=10))
    fwd = MODELS[arch][1].make_forward(tcfg)
    args = (tp, tb["latents"], tb["timesteps"], *_cond(arch, tb))
    whole = fwd(*args)
    monkeypatch.setattr(cm, "ATTN_SCORE_BYTES", 1)
    got = fwd(*args)
    err = float((got - whole).abs().max())
    assert err <= F32_RTOL * float(whole.abs().max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_carry_both_trees(arch, dtype, zoo, tmp_path):
    """The port's manager restores the reference's saved params bit for
    bit, and its own."""
    jp, tp, _, _ = zoo(arch, dtype)
    JaxManager(str(tmp_path / "jax"), keep=1).save(2, {"params": jp})
    got, _, step = CheckpointManager(str(tmp_path / "jax")).restore({"params": tp})
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(3, {"params": tp})
    got, _, _ = mgr.restore({"params": tp})
    for a, b in zip(tree_leaves(got), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
