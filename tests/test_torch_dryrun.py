"""PyTorch port, the dry-run drivers (``repro_torch.launch.{flops, cells,
opcost, dryrun}``) held to the JAX package's ``repro.launch`` on the CPU.

  * ``flops.traced_flops`` against the reference's jaxpr walker on its own
    tests' matmul, loop and conv cases (``tests/test_hlocost.py``): equal;
    on each family's ``smoke_config()`` (an LM's loss gradient, DiT's loss
    gradient, ResNet-50's forward) the product and convolution part equal
    to the reference's dot and conv count, the total within 10 %. llama4's
    chunked layers: the reference's ``lax.cond`` counts the larger branch
    (full attention), the port the branch that runs; the difference is
    4 * B * H * D * S * (S - chunk) a chunked layer, by hand;
  * ``build_cell`` for all 48 cells (the 40 assigned and the 8 dehaze) on
    a (16, 16) and a (2, 16, 16) mesh against the reference's, which runs
    in a child with 512 forced host devices and its ``traced_flops``
    stubbed (a patch in the child, not an edit): kind, every argument's
    shape and dtype, every leaf's spec against its ``PartitionSpec``,
    ``six_nd``, ``steps_multiplier``, ``note`` and the donation record;
    the port's side on a stand-in mesh (axis names and sizes);
  * ``model_flops`` at published widths for six cells against the
    reference's unstubbed ``build_cell`` on a 256-device child: product
    part equal (the dehaze step's luminance is a dot in the reference and
    elementwise in the port: 6 FLOPs a pixel, by hand), total within 10 %;
  * ``_zero1_pspecs`` on each family's table; the ring derating against
    ``hlocost`` on HLO of each collective kind; DTensor placements;
  * one ``run_cell`` on a fake 8-rank group in a child (llama3-8b
    ``decode_32k`` cut to 2 layers, ``decode_seq_shard``, a (2 data, 4
    model) mesh): status ok, and the collectives' kinds, calls and wire
    bytes as counted by hand.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import flops as jflops
from repro.launch import hlocost
from repro.models import common as jcm
from repro_torch import configs
from repro_torch.launch import cells, flops, opcost
from repro_torch.models import common as cm

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _child(body: str, devices: int) -> dict:
    """Run ``body`` (which prints one JSON line last) with ``devices``
    forced host devices; its printed object."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"child failed:\n{proc.stdout}\n{proc.stderr}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


# The reference walker's dot and conv part: its ``_jaxpr_flops`` with
# every other primitive left out (scan bodies times their length, the
# larger cond branch, calls followed), shared with the children below.
_PRODUCTS = """
def products(jaxpr):
    from repro.launch import flops as jf
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += jf._dot_flops(eqn)
        elif prim == "conv_general_dilated":
            total += jf._conv_flops(eqn)
        elif prim == "scan":
            total += eqn.params["length"] * products(eqn.params["jaxpr"].jaxpr)
        elif prim == "while":
            total += products(eqn.params["body_jaxpr"].jaxpr)
        elif prim == "cond":
            total += max((products(b.jaxpr) for b in eqn.params["branches"]),
                         default=0.0)
        else:
            inner = (eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
                     or eqn.params.get("fun_jaxpr"))
            if inner is not None:
                total += products(getattr(inner, "jaxpr", inner))
    return total
"""
exec(_PRODUCTS)


def _jax_counts(fn, *args):
    """The reference walker's (total, dot and conv part)."""
    return (jflops.traced_flops(fn, *args),
            products(jax.make_jaxpr(fn)(*args).jaxpr))  # noqa: F821


class _Mesh:
    """A stand-in mesh: axis names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape[i]


MESHES = {2: ((16, 16), ("data", "model")),
          3: ((2, 16, 16), ("pod", "data", "model"))}


# --- the FLOP counter ----------------------------------------------------------

def test_traced_flops_matmul():
    a = jax.ShapeDtypeStruct((64, 128), jnp.float32)
    b = jax.ShapeDtypeStruct((128, 32), jnp.float32)
    want = jflops.traced_flops(lambda x, y: x @ y, a, b)
    got = flops.traced_flops(lambda x, y: x @ y, torch.empty(64, 128), torch.empty(128, 32))
    assert got == want == 2 * 64 * 128 * 32
    assert got.matmul_flops == want


def test_traced_flops_loop_counts_each_trip():
    def jf(x, ws):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]

    def tf(x, ws):
        for w in ws:
            x = x @ w
        return x
    want = jflops.traced_flops(jf, jax.ShapeDtypeStruct((8, 16), jnp.float32),
                               jax.ShapeDtypeStruct((5, 16, 16), jnp.float32))
    got = flops.traced_flops(tf, torch.empty(8, 16), torch.empty(5, 16, 16))
    assert got == want == 5 * 2 * 8 * 16 * 16


def test_traced_flops_conv():
    def jf(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = jflops.traced_flops(jf, jax.ShapeDtypeStruct((1, 10, 10, 4), jnp.float32),
                               jax.ShapeDtypeStruct((3, 3, 4, 8), jnp.float32))
    got = flops.traced_flops(lambda x, w: cm.conv2d(x, w, padding="VALID"),
                             torch.empty(1, 10, 10, 4), torch.empty(3, 3, 4, 8))
    assert got == want == 2 * (8 * 8 * 8) * 9 * 4
    assert got.matmul_flops == want


def _lm_pair(arch):
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    from repro_torch.models.steps import value_and_grad
    jcfg = jconfigs.get_module(arch).smoke_config()
    tcfg = configs.get_module(arch).smoke_config()
    b, s = 2, 16
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    jl = JT.make_loss_fn(jcfg, None, None)
    want = _jax_counts(lambda p, bt: jax.grad(lambda pp: jl(pp, bt)[0])(p),
                       jcm.param_shapes(JT.lm_param_table(jcfg)),
                       {"tokens": toks, "labels": toks})
    tl = T.make_loss_fn(tcfg)
    tt = torch.empty(b, s, dtype=torch.int32)
    got = flops.traced_flops(lambda p, bt: value_and_grad(tl, p, bt),
                             cm.param_shapes(T.lm_param_table(tcfg)),
                             {"tokens": tt, "labels": tt})
    return tcfg, b, s, want, got


@pytest.mark.parametrize("arch", ["llama3-8b", "moonshot-v1-16b-a3b"])
def test_smoke_lm_gradient_flops(arch):
    _, _, _, (total, products), got = _lm_pair(arch)
    assert got.matmul_flops == products
    assert abs(float(got) - total) <= 0.1 * total


def test_smoke_llama4_flops_differ_by_the_cond():
    """The reference counts full attention on the chunked layers (the
    larger ``lax.cond`` branch); the port counts the chunked products it
    runs. Forward and backward: 3x the forward's 4 * B * H * D * S * (S -
    w) a chunked layer."""
    cfg, b, s, (total, products), got = _lm_pair("llama4-scout-17b-a16e")
    chunked = sum((i + 1) % cfg.global_every != 0 for i in range(cfg.n_layers))
    diff = 3 * chunked * 4 * b * cfg.n_heads * cfg.head_dim * s * (s - cfg.chunk_attn)
    assert got.matmul_flops == products - diff
    assert abs(float(got) - total) <= 0.1 * total


def test_smoke_dit_gradient_flops():
    from repro.models import dit as JD
    from repro_torch.models import dit as D
    from repro_torch.models.steps import value_and_grad
    jcfg = jconfigs.get_module("dit-l2").smoke_config()
    tcfg = configs.get_module("dit-l2").smoke_config()
    r, b = jcfg.img_res // 8, 2
    jb = {"latents": jax.ShapeDtypeStruct((b, r, r, 4), jnp.float32),
          "noise": jax.ShapeDtypeStruct((b, r, r, 4), jnp.float32),
          "timesteps": jax.ShapeDtypeStruct((b,), jnp.int32),
          "labels": jax.ShapeDtypeStruct((b,), jnp.int32)}
    jl = JD.make_loss_fn(jcfg, None, None)
    total, products = _jax_counts(lambda p, bt: jax.grad(lambda pp: jl(pp, bt)[0])(p),
                                  jcm.param_shapes(JD.dit_param_table(jcfg)), jb)
    tb = {k: torch.empty(v.shape, dtype=torch.float32 if v.dtype == jnp.float32
                         else torch.int32) for k, v in jb.items()}
    tl = D.make_loss_fn(tcfg, None, None)
    got = flops.traced_flops(lambda p, bt: value_and_grad(tl, p, bt),
                             cm.param_shapes(D.dit_param_table(tcfg)), tb)
    assert got.matmul_flops == products
    assert abs(float(got) - total) <= 0.1 * total


def test_smoke_resnet_forward_flops():
    from repro.models import resnet as JR
    from repro_torch.models import resnet as R
    jcfg = jconfigs.get_module("resnet-50").smoke_config()
    tcfg = configs.get_module("resnet-50").smoke_config()
    res = jcfg.img_res
    total, products = _jax_counts(
        lambda p, x: JR.make_forward(jcfg)(p, x)[0],
        jcm.param_shapes(JR.resnet_param_table(jcfg)),
        jax.ShapeDtypeStruct((2, res, res, 3), jnp.float32))
    got = flops.traced_flops(lambda p, x: R.make_forward(tcfg)(p, x)[0],
                             cm.param_shapes(R.resnet_param_table(tcfg)),
                             torch.empty(2, res, res, 3))
    assert got.matmul_flops == products
    assert abs(float(got) - total) <= 0.1 * total


# --- the cells -----------------------------------------------------------------

_REF_CELLS = """
    import json
    import jax
    from repro import configs
    from repro.launch import cells
    from repro.core import compat
    cells.flops_mod.traced_flops = lambda *a, **k: 0.0
    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in p]
    out = {}
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        mesh = compat.make_mesh(shape, axes)
        for a, s in configs.all_cells(include_dehaze=True):
            key = f"{len(shape)}:{a}:{s}"
            try:
                c = cells.build_cell(a, s, mesh)
            except cells.CellSkip as e:
                out[key] = {"skip": str(e)}
                continue
            out[key] = {
                "kind": c.kind,
                "args": [[list(x.shape), str(x.dtype)]
                         for x in jax.tree_util.tree_leaves(c.args)],
                "specs": [spec(sh.spec) for sh in jax.tree_util.tree_leaves(c.in_shardings)],
                "six_nd": c.six_nd, "steps_multiplier": c.steps_multiplier,
                "note": c.note, "donate": list(c.donate_argnums)}
    print(json.dumps(out))
"""


def _leaves(tree, is_leaf=None):
    """Leaves in the JAX package's order (dicts by sorted key, dataclasses
    by field)."""
    import dataclasses
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum((_leaves(getattr(tree, f.name), is_leaf)
                    for f in dataclasses.fields(tree)), [])
    if isinstance(tree, dict):
        return sum((_leaves(tree[k], is_leaf) for k in sorted(tree)), [])
    if isinstance(tree, (list, tuple)):
        return sum((_leaves(v, is_leaf) for v in tree), [])
    return [tree]


@pytest.fixture(scope="module")
def ref_cells():
    return _child(_REF_CELLS, 512)


@pytest.mark.parametrize("ndim", [2, 3])
def test_build_cell_matches_reference(ref_cells, ndim, monkeypatch):
    monkeypatch.setattr(cells.flops_mod, "traced_flops",
                        lambda *a, **k: flops.FlopCount(0.0, 0.0))
    mesh = _Mesh(*MESHES[ndim])
    counts = {"ok": 0, "skip": 0}
    for a, s in configs.all_cells(include_dehaze=True):
        want = ref_cells[f"{ndim}:{a}:{s}"]
        try:
            c = cells.build_cell(a, s, mesh)
        except cells.CellSkip as e:
            assert want == {"skip": str(e)}, (a, s)
            counts["skip"] += 1
            continue
        got = {"kind": c.kind,
               "args": [[list(x.shape), cm.dtype_name(x.dtype)] for x in _leaves(c.args)],
               "specs": [[list(e) if isinstance(e, tuple) else e for e in p]
                         for t in c.in_shardings for p in _leaves(t, cm.is_spec)],
               "six_nd": c.six_nd, "steps_multiplier": c.steps_multiplier,
               "note": c.note, "donate": list(c.donate_argnums)}
        for k in want:
            assert got[k] == want[k], (a, s, k)
        assert all(x.is_meta for x in _leaves(c.args))
        counts["ok"] += 1
    assert counts == {"ok": 45, "skip": 3}


SIX = [("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k"),
       ("moonshot-v1-16b-a3b", "prefill_32k"), ("dit-l2", "gen_fast"),
       ("resnet-50", "serve_b128"), ("dehaze-dcp", "stream_480p")]

_REF_FLOPS = """
    import json
    import jax
    from repro.launch import cells, flops
    from repro.core import compat
    %s
    walker = flops.traced_flops
    seen = []
    def both(fn, *args, **kw):
        seen.append(products(jax.make_jaxpr(fn, **kw)(*args).jaxpr))
        return walker(fn, *args, **kw)
    cells.flops_mod.traced_flops = both
    mesh = compat.make_mesh((16, 16), ("data", "model"))
    out = {}
    for a, s in %r:
        out[f"{a}:{s}"] = [cells.build_cell(a, s, mesh).model_flops, seen[-1]]
    print(json.dumps(out))
""" % (textwrap.indent(_PRODUCTS, "    ").strip(), SIX)


def test_model_flops_at_published_widths():
    """Products equal, but for the dehaze step's luminance: the
    reference's is a ``dot_general`` of each pixel's RGB with 3 weights
    (2 * 3 FLOPs a pixel), the port's three multiplies and two adds
    (elementwise)."""
    want = _child(_REF_FLOPS, 256)
    mesh = _Mesh(*MESHES[2])
    for a, s in SIX:
        total, products = want[f"{a}:{s}"]
        if a.startswith("dehaze"):
            shape = configs.DEHAZE_SHAPES[s]
            products -= 2 * 3 * shape["batch"] * shape["height"] * shape["width"]
        mf = cells.build_cell(a, s, mesh).model_flops
        assert mf.matmul_flops == products, (a, s)
        assert abs(float(mf) - total) <= 0.1 * total, (a, s, float(mf), total)


@pytest.mark.parametrize("arch", ["llama3-8b", "dit-l2", "resnet-50", "vit-l16"])
def test_zero1_pspecs_match(arch):
    from repro.launch.mesh import batch_axes_for as jbatch
    mod, jmod = configs.get_module(arch), jconfigs.get_module(arch)
    if mod.FAMILY == "lm":
        from repro.models import transformer as JT
        from repro_torch.models import transformer as T
        table, jtable = T.lm_param_table(mod.config()), JT.lm_param_table(jmod.config())
    elif arch == "dit-l2":
        from repro.models import dit as JD
        from repro_torch.models import dit as D
        table, jtable = D.dit_param_table(mod.config()), JD.dit_param_table(jmod.config())
    elif arch == "resnet-50":
        from repro.models import resnet as JR
        from repro_torch.models import resnet as R
        table = R.resnet_param_table(mod.config())
        jtable = JR.resnet_param_table(jmod.config())
    else:
        from repro.models import vit as JV
        from repro_torch.models import vit as V
        table, jtable = V.vit_param_table(mod.config()), JV.vit_param_table(jmod.config())

    class JMesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 16, "model": 16}
    for axes, n in ((("data",), 16), (("pod", "data"), 32)):
        sizes = dict(JMesh.shape)
        got = cells._zero1_pspecs(table, cm.param_pspecs(table, mesh=sizes), axes, n)
        want = jcells._zero1_pspecs(jtable, jcm.param_pspecs(jtable, mesh=JMesh), axes, n)
        jl = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, P))
        assert [tuple(p) for p in jl] == _leaves(got, cm.is_spec)
    assert jbatch(JMesh, 256) == ("pod", "data")


# --- the cost model ------------------------------------------------------------

_HLO = """\
HloModule t

ENTRY %main (a: f32[16,16]) -> f32[16,16] {{
  %a = f32[16,16]{{1,0}} parameter(0)
  %c = {out} {op}(%a), replica_groups=[16,16]<=[256]{extra}
  ROOT %o = f32[16,16]{{1,0}} add(%a, %a)
}}
"""


@pytest.mark.parametrize("kind,out_shape", [
    ("all-gather", (16, 16)), ("all-reduce", (16, 16)),
    ("reduce-scatter", (1, 16)), ("all-to-all", (16, 16)),
    ("collective-permute", (16, 16))])
def test_ring_derating_matches_hlocost(kind, out_shape):
    extra = {"all-gather": ", dimensions={0}", "reduce-scatter": ", dimensions={0}",
             "all-to-all": ", dimensions={0}"}.get(kind, "")
    if kind == "collective-permute":
        extra = ", source_target_pairs={{0,1}}"
    out = f"f32[{out_shape[0]},{out_shape[1]}]{{1,0}}"
    cost = hlocost.cost_from_hlo_text(_HLO.format(out=out, op=kind, extra=extra))
    nbytes = out_shape[0] * out_shape[1] * 4
    assert opcost.ring_wire_bytes(kind, nbytes, 16) == pytest.approx(
        cost.collective_bytes[kind], rel=1e-12)


def test_ring_derating_of_the_reference_samples():
    """``tests/test_hlocost.py``'s numbers: an all-reduce of 256 bytes in
    groups of 8, an all-gather and a permute of 1024 bytes in 16."""
    assert opcost.ring_wire_bytes("all-reduce", 256, 8) == 2 * (7 / 8) * 256
    assert opcost.ring_wire_bytes("all-gather", 1024, 16) == 1024 * 15 / 16
    assert opcost.ring_wire_bytes("collective-permute", 1024, 16) == 1024
    cost = opcost.cost_from_ops([["mm", 10.0, 4.0], ["c10d.allreduce_", 0.0, 256.0,
                                                      "all-reduce", 256.0, 8]])
    assert cost.flops == 10.0 and cost.traffic_bytes == 260.0
    assert cost.collective_total == 2 * (7 / 8) * 256


def test_placements_as_dtensor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh((2, 16, 16), ("pod", "data", "model"))
    got = cells.placements((("pod", "data"), None, "model"), mesh)
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert cells.placements((None, None), mesh) == [Replicate()] * 3


# --- one run_cell on a fake group ------------------------------------------------

_RUN_CELL = """
    import json, sys, warnings
    warnings.simplefilter("ignore")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import cells, dryrun, flops
    cells.flops_mod.traced_flops = lambda *a, **k: flops.FlopCount(1.0, 1.0)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rec = dryrun.run_cell("llama3-8b", "decode_32k", force=True, mesh=mesh,
                          overrides={"decode_seq_shard": True, "n_layers": 2},
                          variant="cut", results_dir=sys.argv[1])
    print(json.dumps(rec))
"""


def test_run_cell_on_a_fake_group(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_RUN_CELL),
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    # By hand: batch 128 over data 2 -> 64 rows a rank; per layer the
    # flash-decoding combine (MAX of (64, 32, 1) f32, SUMs of it and of
    # (64, 32, 1, 128) f32) and the MLP's w_down partial sum (64, 1, 4096)
    # f32; the vocab-sharded embedding's rows (64, 1, 4096) bf16 once; the
    # logits gathered over 4 ranks, (64, 1, 128256) bf16.
    per_layer = [64 * 32 * 4, 64 * 32 * 4, 64 * 32 * 128 * 4, 64 * 4096 * 4]
    all_reduce = [64 * 4096 * 2] + 2 * per_layer
    assert rec["collective_calls"] == {"all-reduce": len(all_reduce), "all-gather": 1}
    want = {"all-reduce": sum(2 * 0.75 * b for b in all_reduce),
            "all-gather": 0.75 * 64 * 128256 * 2}
    assert rec["collective_bytes_per_device"] == pytest.approx(want, rel=1e-12)
    assert rec["n_devices"] == 8 and rec["kind"] == "decode"
    # The cache's slice of the sequence (2 layers, 64 rows, 8192 of 32768
    # positions, 8 kv heads) and the tokens: what the rank holds.
    args = rec["memory_analysis"]["argument_bytes"]
    assert args["cache"] == 2 * 2 * 64 * (32768 // 4) * 8 * 128 * 2 + 4
    assert args["tokens"] == 64 * 4
    assert rec["memory_analysis"]["peak_bytes"] >= sum(args.values())
    assert os.path.exists(tmp_path / "ops" / "llama3-8b__decode_32k__mesh2x4__cut.json.gz")
