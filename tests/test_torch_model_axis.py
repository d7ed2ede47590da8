"""PyTorch port, the LM's model axis (``repro_torch.models.transformer`` on
a mesh) held to the JAX package on the CPU, at the sizes of the
reference's own ``tests/test_distributed.py`` (2 layers, d_model 32, 4
heads, vocab 64, float32).

Eight gloo ranks in child processes (file rendezvous) form a (2 data, 4
model) mesh; each holds its pieces of the reference's params
(``common.shard_params`` by ``transformer.lm_param_specs``) and its half
of the batch, and runs every case. Against JAX's one-device run at the
reference's tolerances (logits 3e-4, cache 1e-5):

  * the expert all-to-all (capacity factor 8, no token drops), with and
    without ``seq_shard``; the dense tensor-parallel forward (4 kv heads
    over 4 ranks) with and without ``seq_shard``; ``embed_shard="dm"``;
  * flash-decoding (``decode_seq_shard``, the cache's sequence over
    "model") with ``chunk_attn`` 0 and 8: a prefill of 16 tokens into 32
    positions, then one decode token, logits and each rank's cache slice;
  * the replicated MoE body in decode (one token does not shard);
  * at capacity factor 1.25, where tokens drop, against the JAX package's
    own sharded forward on an 8-device mesh in a child process (the
    reference's ``run_child``): the same tokens drop on both sides, logits
    within 3e-4, and the aux loss (meaned over the model and batch axes).

One step of the sharded train step (``models.steps.TrainPlacement``,
ZeRO-1 moments over data) with the model axis as the forward places it,
``seq_shard``, microbatches with the accumulators placed as the moments,
and the expert all-to-all with its aux loss, against the JAX package's
jitted step on the same mesh in the 8-device child (the reference cells'
shardings): loss, global norm, and each rank's pieces of the new params,
mu and nu.

The dry run's data-parallel vision step (ResNet-50's smoke config on the
same mesh): BatchNorm's statistics over the whole batch, so its loss and
gradients equal the one-device step's on all the images.

The params carried across: ``shard_params`` then ``unshard_params`` give
back every leaf bit for bit on a (2, 4) and a (2, 2, 2) mesh, a leaf over
a tuple of axes among them, and ``local_shard``'s slice for each device
equals the one ``NamedSharding`` puts there
(``addressable_devices_indices_map`` in the 8-device child).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import common as jcm
from repro.models import transformer as JT
from repro_torch.models import common as cm
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab=64, dtype="float32", kv_block=16, remat=False)
MOE = dict(moe_experts=8, moe_topk=2)
# name -> (config fields, kind): "forward" on (4, 8) tokens (16 for the
# dense cases, the reference's), "serve" a prefill of 16 then 1 decode.
CASES = {
    "moe": (dict(BASE, **MOE, moe_capacity_factor=8.0), "forward"),
    "moe_seq_shard": (dict(BASE, **MOE, moe_capacity_factor=8.0, seq_shard=True),
                      "forward"),
    "dense": (dict(BASE, n_kv_heads=4), "forward"),
    "dense_seq_shard": (dict(BASE, n_kv_heads=4, seq_shard=True), "forward"),
    "embed_dm": (dict(BASE, embed_shard="dm"), "forward"),
    "flash_chunk0": (dict(BASE, chunk_attn=0, global_every=2,
                          decode_seq_shard=True), "serve"),
    "flash_chunk8": (dict(BASE, chunk_attn=8, global_every=2,
                          decode_seq_shard=True), "serve"),
    "moe_decode": (dict(BASE, **MOE, moe_capacity_factor=8.0), "serve"),
    "moe_drops": (dict(BASE, **MOE, moe_capacity_factor=1.25), "forward"),
}
SEQ = {"dense": 16, "dense_seq_shard": 16}
# Sharded train steps: name -> (case whose config and params it takes,
# microbatches, float32 accumulators placed as the moments).
TRAIN = {"tp_seq_shard": ("dense_seq_shard", 1, False),
         "tp_microbatches": ("dense", 2, True),
         "experts": ("moe", 1, False)}
# Spec trees of the params test: a leaf over a tuple of axes, one over
# "model", one over "data" and "model", one whole.
SPECS = {
    (2, 4): {"a": (("data", "model"), None), "b": (None, "model"),
             "c": ("data", None, "model"), "d": (None,)},
    (2, 2, 2): {"a": (("pod", "data"), "model"), "b": ("model", None),
                "c": ("pod", None, ("data", "model")), "d": (None,)},
}
SHAPES = {"a": (8, 12), "b": (4, 8), "c": (4, 3, 8), "d": (5,)}
# The update rule of tests/test_torch_train.py.
UPDATE_RTOL = 1e-4
GRAD_RTOL = 1e-4
TINY_G = 1e-6
MAX_EXCEPTED = 1e-3


def _jcfg(name):
    return JT.LMConfig(**CASES[name][0])


def _tokens(name):
    seq = 17 if CASES[name][1] == "serve" else SEQ.get(name, 8)
    rows = 2 if CASES[name][1] == "serve" else 4
    return np.random.default_rng(1).integers(0, 64, (rows, seq)).astype(np.int32)


def _ref_params(cfg):
    return jax.tree.map(np.asarray, jcm.init_params(jax.random.key(0),
                                                    JT.lm_param_table(cfg)))


_RANK = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 8),
                            rank=rank, world_size=8)
    data = np.load(tmp + "/in.npz", allow_pickle=True)
    cases = data["cases"].item()
    res = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    res["coords"] = np.asarray([d, m])
    for name, (fields, kind) in cases.items():
        cfg = T.LMConfig(**fields)
        table = T.lm_param_table(cfg)
        _, treedef = tree_flatten(table, is_leaf=lambda s: isinstance(s, cm.ParamSpec))
        n = sum(1 for k in data.files if k.startswith(name + "/p"))
        full = tree_unflatten(treedef, [torch.from_numpy(data[f"{name}/p{i}"])
                                        for i in range(n)])
        serving = kind == "serve"
        local = cm.shard_params(full, T.lm_param_specs(cfg, mesh, serving), mesh)
        toks = torch.from_numpy(data[f"{name}/tokens"])
        b = toks.shape[0] // 2
        mine = toks[d * b:(d + 1) * b]
        if kind == "forward":
            logits, aux = T.make_forward(cfg, mesh, ("data",))(local, mine)
            res[f"{name}/logits"] = logits.numpy()
            res[f"{name}/aux"] = aux.numpy()
        else:
            _, cache = T.make_prefill(cfg, mesh, ("data",), max_len=32)(local, mine[:, :16])
            logits, cache = T.make_decode_step(cfg, mesh, ("data",))(local, cache, mine[:, 16:17])
            res[f"{name}/logits"] = logits.numpy()
            res[f"{name}/k"] = cache["k"].numpy()
            res[f"{name}/pos"] = cache["pos"].numpy()
    # Sharded train steps: ZeRO-1 moments over data, the model axis as
    # the forward places it; the aux loss on. First the gradient meaned
    # over data, whole (for the update check's exceptions), then the step.
    from repro_torch.launch.cells import _zero1_pspecs
    from repro_torch.models import parallel as par
    from repro_torch.optim import cosine_schedule
    for name, (case, micro, accum) in data["train"].item().items():
        cfg = T.LMConfig(**cases[case][0])
        table = T.lm_param_table(cfg)
        _, treedef = tree_flatten(table, is_leaf=lambda s: isinstance(s, cm.ParamSpec))
        n = sum(1 for k in data.files if k.startswith(case + "/p"))
        full = tree_unflatten(treedef, [torch.from_numpy(data[f"{case}/p{i}"])
                                        for i in range(n)])
        specs = T.lm_param_specs(cfg, mesh)
        mspecs = _zero1_pspecs(table, specs, ("data",), 2)
        pl = steps.TrainPlacement(mesh, ("data",), specs, mspecs)
        local = cm.shard_params(full, specs, mesh)
        loss_fn = T.make_loss_fn(cfg, mesh, ("data",))
        toks = torch.from_numpy(data["train/tokens"])
        mine = {"tokens": toks[d * 2:(d + 1) * 2, :-1], "labels": toks[d * 2:(d + 1) * 2, 1:]}
        grads = steps.value_and_grad(loss_fn, local, mine)[2]
        grads = cm.unshard_params(tree_map(
            lambda g: par.all_reduce_(g.contiguous(), mesh.get_group("data")) / 2,
            grads), specs, mesh)
        step = steps.make_train_step(
            loss_fn, cosine_schedule(1e-2, 0, 10), microbatches=micro,
            accum_shardings=mspecs if accum else None, placement=pl)
        local, opt, m = step(local, steps.init_opt_state(local, pl), mine)
        for key in ("loss", "grad_norm", "lr"):
            res[f"train/{name}/{key}"] = m[key].numpy()
        for what, tree in (("g", grads), ("p", local), ("mu", opt.mu), ("nu", opt.nu)):
            for i, leaf in enumerate(tree_flatten(tree)[0]):
                res[f"train/{name}/{what}{i}"] = leaf.numpy()
    # ResNet-50's smoke config, data-parallel (the dry run's vision
    # step): loss and gradients on this rank's 4 images, BatchNorm over
    # all 8, the head's "model"-split columns gathered.
    from repro_torch import configs
    from repro_torch.launch import cells
    from repro_torch.models import resnet as RN
    rcfg = configs.get_module("resnet-50").smoke_config()
    rtable = RN.resnet_param_table(rcfg)
    _, rdef = tree_flatten(rtable, is_leaf=lambda s: isinstance(s, cm.ParamSpec))
    n = sum(1 for k in data.files if k.startswith("resnet/p"))
    rfull = tree_unflatten(rdef, [torch.from_numpy(data[f"resnet/p{i}"])
                                  for i in range(n)])
    rspecs = cm.param_pspecs(rtable, mesh=cm.mesh_sizes(mesh))
    loss = cells._gathered(RN.make_loss_fn(rcfg, mesh, ("data",)), rspecs, mesh)
    batch = {"images": torch.from_numpy(data["resnet/images"][d * 4:(d + 1) * 4]),
             "labels": torch.from_numpy(data["resnet/labels"][d * 4:(d + 1) * 4])}
    value, metrics, grads = steps.value_and_grad(
        loss, cm.shard_params(rfull, rspecs, mesh), batch)
    grads = cm.unshard_params(tree_map(
        lambda g: par.all_reduce_(g.contiguous(), mesh.get_group("data")) / 2,
        grads), rspecs, mesh)
    res["resnet/loss"] = (par.all_reduce_(value.reshape(1), mesh.get_group("data")) / 2).numpy()
    for i, leaf in enumerate(tree_flatten(grads)[0]):
        res[f"resnet/g/{i}"] = leaf.numpy()
    for i, leaf in enumerate(tree_flatten(metrics["bn_params"])[0]):
        res[f"resnet/bn/{i}"] = leaf.numpy()
    # The params carried across, on (2, 4) and on (2, 2, 2).
    specs = data["specs"].item()
    for shape in ((2, 4), (2, 2, 2)):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        full = {k: torch.from_numpy(data[f"tree/{k}"]) for k in "abcd"}
        local = cm.shard_params(full, specs[shape], mesh)
        back = cm.unshard_params(local, specs[shape], mesh)
        for k in "abcd":
            res[f"{shape}/{k}"] = back[k].numpy()
    np.savez(tmp + f"/out{rank}.npz", **res)
    dist.destroy_process_group()
    # Leave without the interpreter's teardown: under load, torch's C++
    # teardown at exit can abort a rank (std::terminate) after its outputs
    # are saved.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
""")

_JAX_CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import compat
    from repro.models import transformer as T, common as cm
    tmp = sys.argv[1]
    data = np.load(tmp + "/in.npz", allow_pickle=True)
    fields, _ = data["cases"].item()["moe_drops"]
    cfg = T.LMConfig(**fields)
    params = cm.init_params(jax.random.key(0), T.lm_param_table(cfg))
    toks = jnp.asarray(data["moe_drops/tokens"])
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    pspecs = cm.param_pspecs(T.lm_param_table(cfg), mesh=mesh)
    shard = jax.tree.map(lambda p: NamedSharding(mesh, p), pspecs,
                         is_leaf=lambda x: isinstance(x, P))
    with mesh:
        logits, aux = jax.jit(T.make_forward(cfg, mesh, ("data",)),
                              in_shardings=(shard, NamedSharding(mesh, P("data", None))))(
            params, toks)
    out = {"logits": np.asarray(logits), "aux": np.asarray(aux)}
    # Where NamedSharding puts each slice, by mesh coordinates.
    maps = {}
    specs = data["specs"].item()
    for shape, names in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        m = compat.make_mesh(shape, names)
        for k, spec in specs[shape].items():
            x = jnp.zeros(data[f"tree/{k}"].shape)
            sh = NamedSharding(m, P(*spec))
            for dev, idx in sh.addressable_devices_indices_map(x.shape).items():
                coords = [int(c) for c in np.argwhere(m.devices == dev)[0]]
                maps[f"{shape}/{k}/{coords}"] = [[s.start, s.stop] if isinstance(s, slice)
                                                 else s for s in idx]
    out["maps"] = np.asarray(json.dumps(maps))
    np.savez(tmp + "/jax.npz", **out)
""")

_JAX_TRAIN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import compat
    from repro.launch import cells as C
    from repro.models import steps as S, transformer as T, common as cm
    from repro.optim import adamw_init, cosine_schedule
    tmp = sys.argv[1]
    data = np.load(tmp + "/in.npz", allow_pickle=True)
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    out = {}
    # The sharded train steps: the reference's jitted step on the (2, 4)
    # mesh with the cells' param and ZeRO-1 shardings (and accum_shardings
    # under microbatches), and its jitted gradient, on the ranks' params.
    for name, (case, micro, accum) in data["train"].item().items():
        cfg = T.LMConfig(**data["cases"].item()[case][0])
        table = T.lm_param_table(cfg)
        treedef = jax.tree.structure(cm.param_shapes(table))
        params = jax.tree.unflatten(treedef, [jnp.asarray(data[f"{case}/p{i}"])
                                              for i in range(treedef.num_leaves)])
        _, _, pspecs, ospecs = C._opt_shapes_and_shardings(table, mesh, ("data",),
                                                           rules=T.lm_rules(cfg))
        loss = T.make_loss_fn(cfg, mesh, ("data",))
        step = S.make_train_step(loss, cosine_schedule(1e-2, 0, 10), microbatches=micro,
                                 accum_shardings=C._shard(mesh, ospecs.mu) if accum else None)
        bsh = NamedSharding(mesh, P("data", None))
        toks = jnp.asarray(data["train/tokens"])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        with mesh:
            p = jax.device_put(params, C._shard(mesh, pspecs))
            o = jax.device_put(adamw_init(params), C._shard(mesh, ospecs))
            batch = jax.device_put(batch, {"tokens": bsh, "labels": bsh})
            g = jax.jit(jax.grad(lambda pp, bb: loss(pp, bb)[0]))(p, batch)
            newp, newo, m = jax.jit(step)(p, o, batch)
        for key in ("loss", "grad_norm", "lr"):
            out[f"train/{name}/{key}"] = np.asarray(m[key])
        for what, tree in (("g", g), ("p", newp), ("mu", newo.mu), ("nu", newo.nu)):
            for i, leaf in enumerate(jax.tree.leaves(tree)):
                out[f"train/{name}/{what}{i}"] = np.asarray(leaf)
    np.savez(tmp + "/jax_train.npz", **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the eight ranks and the 8-device JAX child at once; collect."""
    tmp = tmp_path_factory.mktemp("model_axis")
    rng = np.random.default_rng(7)
    arrays = {"cases": np.asarray(CASES, dtype=object),
              "specs": np.asarray(SPECS, dtype=object)}
    for name in CASES:
        for i, leaf in enumerate(jax.tree_util.tree_leaves(_ref_params(_jcfg(name)))):
            arrays[f"{name}/p{i}"] = leaf
        arrays[f"{name}/tokens"] = _tokens(name)
    for k, shape in SHAPES.items():
        arrays[f"tree/{k}"] = rng.standard_normal(shape).astype(np.float32)
    for i, leaf in enumerate(tree_leaves(_resnet_params())):
        arrays[f"resnet/p{i}"] = leaf.numpy()
    arrays["resnet/images"] = rng.random((8, 32, 32, 3)).astype(np.float32)
    arrays["resnet/labels"] = (np.arange(8) % 16).astype(np.int32)
    arrays["train"] = np.asarray(TRAIN, dtype=object)
    arrays["train/tokens"] = np.random.default_rng(9).integers(
        0, 64, (4, 17)).astype(np.int32)
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(tmp)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(8)]
    jchildren = [subprocess.Popen([sys.executable, "-c", code, str(tmp)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for code in (_JAX_CHILD, _JAX_TRAIN)]
    one = _one_device_runs()                    # while the children run
    for p in procs + jchildren:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"child failed:\n{log}"
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(8)]
    jx = dict(np.load(tmp / "jax.npz"), **np.load(tmp / "jax_train.npz"))
    return arrays, outs, jx, one


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_train_step_matches_jax_sharded_step(runs, name):
    """One step of ``make_train_step(placement=...)`` on the (2 data, 4
    model) mesh against the JAX package's jitted step on the same mesh
    (its cells' param and ZeRO-1 shardings, ``accum_shardings`` under
    microbatches), the aux loss on: the loss within 1e-5 and the clip's
    global norm within 1e-4 relative; on every rank, its piece of each new
    param by ``tests/test_torch_train.py``'s update rule, and its ZeRO-1
    pieces of mu and nu within GRAD_RTOL x the leaf's max |mu| and twice
    that x its max |nu| (the moments are the clipped gradient and its
    square, and the gradients agree within GRAD_RTOL x their max)."""
    from repro_torch.launch.cells import _zero1_pspecs
    from repro_torch.models import transformer as T
    arrays, outs, jx, _ = runs
    case, _, _ = TRAIN[name]
    cfg = T.LMConfig(**CASES[case][0])
    table = T.lm_param_table(cfg)
    sizes = {"data": 2, "model": 4}
    pspecs = T.lm_param_specs(cfg, sizes)
    pspecs, mspecs = (tree_leaves(t, is_leaf=cm.is_spec) for t in (
        pspecs, _zero1_pspecs(table, pspecs, ("data",), 2)))
    lr = float(jx[f"train/{name}/lr"])
    key = f"train/{name}/"
    masks = []                                  # (tiny, drift) a leaf
    for i in range(len(pspecs)):
        w, g = jx[f"{key}g{i}"], outs[0][f"{key}g{i}"]
        err = np.abs(g - w)
        assert err.max() <= GRAD_RTOL * np.abs(w).max() + 1e-30, (name, i)
        masks.append((np.abs(w) < TINY_G, err > UPDATE_RTOL * np.abs(w)))
    tiny_n = drift_n = total = 0
    for o in outs:
        coords = dict(zip(("data", "model"), (int(c) for c in o["coords"])))
        np.testing.assert_allclose(o[key + "loss"], jx[key + "loss"], rtol=1e-5)
        np.testing.assert_allclose(o[key + "grad_norm"], jx[key + "grad_norm"],
                                   rtol=1e-4)
        for i, (ps, ms) in enumerate(zip(pspecs, mspecs)):
            def piece(a, spec):
                return cm.local_shard(torch.from_numpy(np.array(a)), spec, sizes,
                                      coords).numpy()
            p0, want = piece(arrays[f"{case}/p{i}"], ps), piece(jx[f"{key}p{i}"], ps)
            got = o[f"{key}p{i}"]
            tiny, drift = (piece(m, ps) for m in masks[i])
            tol = UPDATE_RTOL * lr + np.spacing(np.abs(want).astype(np.float32))
            bad = np.abs((got - p0) - (want - p0)) > tol
            assert not (bad & ~tiny & ~drift).any(), (
                name, i, coords, np.abs(got - want).max())
            tiny_n += int((bad & tiny).sum())
            drift_n += int((bad & drift & ~tiny).sum())
            total += got.size
            for what, rtol in (("mu", GRAD_RTOL), ("nu", 2 * GRAD_RTOL)):
                full = jx[f"{key}{what}{i}"]
                np.testing.assert_allclose(
                    o[f"{key}{what}{i}"], piece(full, ms), rtol=0,
                    atol=rtol * np.abs(full).max() + 1e-30, err_msg=f"{name} {what}{i}")
    print(f"{name}: of {total} param elements over the ranks, {tiny_n} excepted "
          f"with reference |g| < {TINY_G} and {drift_n} with gradients apart by "
          f"more than {UPDATE_RTOL} relative")
    assert tiny_n <= MAX_EXCEPTED * total, (name, tiny_n, total)


def _resnet_params():
    from repro_torch import configs
    from repro_torch.models import resnet as RN
    table = RN.resnet_param_table(configs.get_module("resnet-50").smoke_config())
    return cm.init_params(table, 5, device="cpu")


def test_data_parallel_batch_norm_is_the_whole_batchs(runs):
    """The dry run's vision train step at ResNet-50's smoke config on the
    (2 data, 4 model) mesh: each rank's loss and gradients on 4 of 8
    images with BatchNorm over all 8 (``common.batch_stats_group``), meaned over
    data, equal the one-device step's on the 8 within 1e-5 x each leaf's
    max |g|; the new running stats within 1e-6."""
    from repro_torch import configs
    from repro_torch.models import resnet as RN
    from repro_torch.models.steps import value_and_grad
    arrays, outs, _, _ = runs
    cfg = configs.get_module("resnet-50").smoke_config()
    batch = {"images": torch.from_numpy(arrays["resnet/images"]),
             "labels": torch.from_numpy(arrays["resnet/labels"])}
    value, metrics, grads = value_and_grad(RN.make_loss_fn(cfg), _resnet_params(),
                                           batch)
    want_bn = tree_leaves(metrics["bn_params"])
    for o in outs:
        np.testing.assert_allclose(o["resnet/loss"][0], float(value), rtol=1e-6)
        for i, w in enumerate(tree_leaves(grads)):
            w = w.numpy()
            np.testing.assert_allclose(o[f"resnet/g/{i}"], w, rtol=0,
                                       atol=1e-5 * max(np.abs(w).max(), 1e-30))
        for i, w in enumerate(want_bn):
            np.testing.assert_allclose(o[f"resnet/bn/{i}"], w.numpy(), rtol=0, atol=1e-6)


def _stitch(outs, key):
    """The (2, B/2, ...) blocks of data ranks 0 and 1 (model rank 0), with
    every model rank's equal to it."""
    rows = {}
    for o in outs:
        d, m = o["coords"]
        if m == 0:
            rows[int(d)] = o[key]
    for o in outs:
        np.testing.assert_array_equal(o[key], rows[int(o["coords"][0])])
    return np.concatenate([rows[0], rows[1]])


def _one_device_runs():
    """JAX's one-device run of each case: the forward's logits, or a
    prefill of 16 of 32 positions and one decode token's logits and K."""
    one = {}
    for name, (_, kind) in CASES.items():
        cfg = _jcfg(name)
        params = _ref_params(cfg)
        toks = jnp.asarray(_tokens(name))
        if kind == "forward":
            one[name] = (np.asarray(jax.jit(JT.make_forward(cfg))(params, toks)[0]),)
            continue
        _, cache = jax.jit(JT.make_prefill(cfg, max_len=32))(params, toks[:, :16])
        logits, cache = jax.jit(JT.make_decode_step(cfg))(params, cache, toks[:, 16:17])
        one[name] = (np.asarray(logits), np.asarray(cache["k"]))
    return one


@pytest.mark.parametrize("name", ["moe", "moe_seq_shard", "dense",
                                  "dense_seq_shard", "embed_dm"])
def test_forward_matches_one_device(runs, name):
    _, outs, _, one = runs
    np.testing.assert_allclose(_stitch(outs, f"{name}/logits"), one[name][0],
                               atol=3e-4, rtol=0)


@pytest.mark.parametrize("name", ["flash_chunk0", "flash_chunk8", "moe_decode"])
def test_decode_matches_one_device(runs, name):
    """Prefill 16 of 32 positions, one decode token: logits and each rank's
    cache (its kv heads, or under ``decode_seq_shard`` its 8 positions)."""
    _, outs, _, one = runs
    cfg = _jcfg(name)
    want, k = one[name]
    np.testing.assert_allclose(_stitch(outs, f"{name}/logits"), want,
                               atol=3e-4, rtol=0)
    for o in outs:
        d, m = (int(c) for c in o["coords"])
        got = o[f"{name}/k"]
        assert int(o[f"{name}/pos"]) == 17
        rows = k[:, d:d + 1]
        if cfg.decode_seq_shard:
            want_k = rows[:, :, m * 8:(m + 1) * 8]
        else:                       # kv heads over "model" where they divide
            h = got.shape[3]
            want_k = rows[:, :, :, m * h:(m + 1) * h] if h < k.shape[3] else rows
        np.testing.assert_allclose(got, want_k, atol=1e-5, rtol=0)


def test_dropping_moe_matches_the_jax_sharded_forward(runs):
    """Capacity factor 1.25: a rank's capacity comes from its own tokens
    (4 of them: 2 rows x 2 positions), so the same tokens drop on both
    sides; aux meaned over the model and batch axes."""
    _, outs, jx, one = runs
    np.testing.assert_allclose(_stitch(outs, "moe_drops/logits"), jx["logits"],
                               atol=3e-4, rtol=0)
    for o in outs:
        np.testing.assert_allclose(o["moe_drops/aux"], jx["aux"], atol=1e-6, rtol=1e-5)
    # Tokens did drop: the one-device forward (its capacity from 32 tokens)
    # differs from the sharded one.
    assert np.abs(one["moe_drops"][0] - jx["logits"]).max() > 1e-3


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_params_round_trip_bit_for_bit(runs, shape):
    arrays, outs, _, _ = runs
    for o in outs:
        for k in "abcd":
            np.testing.assert_array_equal(o[f"{shape}/{k}"], arrays[f"tree/{k}"])


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_local_shard_is_named_shardings_slice(runs, shape):
    arrays, _, jx, _ = runs
    maps = json.loads(str(jx["maps"]))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    sizes = dict(zip(names, shape))
    n = 0
    for key, idx in maps.items():
        sh, k, coords = key.split("/")
        if sh != str(shape):
            continue
        coords = dict(zip(names, json.loads(coords)))
        full = torch.from_numpy(arrays[f"tree/{k}"])
        got = cm.local_shard(full, SPECS[shape][k], sizes, coords)
        want = arrays[f"tree/{k}"][tuple(slice(a, b) for a, b in idx)]
        np.testing.assert_array_equal(got.numpy(), want)
        n += 1
    assert n == 8 * len(SPECS[shape])
