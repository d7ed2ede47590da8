"""Cell builder: (arch x shape x mesh) -> one rank's step and its placements.

The port's counterpart of the reference's ``launch/cells.py``. A *cell* is
one entry of the assigned architecture x input-shape grid (and the eight
dehaze cells). :func:`build_cell` returns what ``dryrun.py`` needs: the
step a rank runs on its own pieces, allocation-free ``meta`` tensors of
the whole arguments, the per-leaf placements (the reference's
``PartitionSpec`` entries as tuples), the donation record, and the
analytic MODEL_FLOPS terms.

Sharding policy (the reference's, as placements on a ``DeviceMesh``):
  - batch over (pod, data) when divisible (else data, else replicated),
    ``launch.mesh.batch_axes_for``;
  - tensor parallelism over "model" by ``param_pspecs`` and ``lm_rules``,
    with LM heads padded to the model-axis size; the LM's forward runs it
    with explicit collectives (``models/transformer.py``);
  - optimizer moments ZeRO-1 sharded (:func:`_zero1_pspecs`): the params'
    specs plus the batch axes on the first still-unsharded divisible
    dimension (``models.steps.TrainPlacement``);
  - KV caches: batch over data axes, kv heads over "model", or the
    sequence over "model" under ``decode_seq_shard``;
  - the diffusion and vision models have no model-axis code in either
    package (GSPMD partitions the reference's): a rank all-gathers the
    leaves ``param_pspecs`` splits over "model" at the start of its step
    (their gradients come back as its pieces) and runs its batch shard,
    training BatchNorm's statistics meaned over the batch axes
    (``common.batch_stats_group``), as GSPMD computes the reference's over
    the whole batch;
  - the dehaze cells run ``make_sharded_dehaze_step`` with
    ``kernel_mode="ref"`` and the height over "model" where it divides,
    as the reference builds them: a dry run on fake tensors cannot launch
    a CUDA kernel, and the reference's cells use the plain path too.

``Cell.step_fn`` is built on its first call, so a cell's placements can be
read on a stand-in mesh (axis names and sizes) without process groups.
``model_flops`` is :func:`repro_torch.launch.flops.traced_flops` of the
unpadded, remat-free reference config, as the reference traces it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs as cfgreg
from repro_torch.launch import flops as flops_mod
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.models import common as cm
from repro_torch.models import parallel as par
from repro_torch.models import steps as steps_mod
from repro_torch.optim import AdamWState, cosine_schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class CellSkip(Exception):
    """Raised when an (arch, shape) cell is a documented skip."""


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                    # train | prefill | decode | sample | serve | dehaze
    step_fn: Callable            # one rank's step on its pieces
    args: Tuple[Any, ...]        # meta tensor trees, the whole arguments
    in_shardings: Tuple[Any, ...]  # per-leaf tuples of mesh-axis entries
    donate_argnums: Tuple[int, ...]
    model_flops: float           # traced ideal FLOPs per step execution
    six_nd: Optional[float]      # brief's 6·N·D / 2·N·D convention (LM/DiT)
    steps_multiplier: int = 1    # e.g. sampler steps for diffusion inference
    note: str = ""


def placements(spec: Tuple, mesh) -> list:
    """A leaf's spec as DTensor placements, one per mesh dimension:
    ``Shard(d)`` where the spec names the mesh axis on tensor dimension
    ``d``, else ``Replicate()``. A dimension over a tuple of axes is
    ``Shard(d)`` on each; DTensor splits it in mesh-dimension order, the
    reference's row-major order where the tuple lists the axes in the
    mesh's order (the cells' ``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in cm._entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


class _Lazy:
    """A step built by ``make()`` on its first call (or :meth:`build`)."""

    def __init__(self, make: Callable[[], Callable]):
        self._make, self._fn = make, None

    def build(self) -> Callable:
        """The step, built now: its process groups are made outside any
        fake tensor mode the call may run under."""
        if self._fn is None:
            self._fn = self._make()
        return self._fn

    def __call__(self, *args):
        return self.build()(*args)


def _zero1_pspecs(table, pspecs, data_axes: Tuple[str, ...], n_data: int):
    """Moment specs: param specs + the data axes on the first unsharded
    divisible dim (ZeRO-1 optimizer-state sharding)."""
    specs, treedef = tree_flatten(table, is_leaf=lambda x: isinstance(x, cm.ParamSpec))
    ps_leaves = tree_leaves(pspecs, is_leaf=cm.is_spec)

    def one(spec: cm.ParamSpec, ps: Tuple) -> Tuple:
        parts = list(ps) + [None] * (len(spec.shape) - len(ps))
        for i, (dim, cur) in enumerate(zip(spec.shape, parts)):
            if cur is None and dim % n_data == 0 and dim >= n_data:
                parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
        return tuple(parts)

    return tree_unflatten(treedef, [one(s, p) for s, p in zip(specs, ps_leaves)])


def _opt_shapes(params_sh) -> AdamWState:
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(f32, params_sh), nu=tree_map(f32, params_sh))


def _opt_shapes_and_shardings(table, sizes, data_axes, rules=None):
    params_sh = cm.param_shapes(table)
    opt_shapes = _opt_shapes(params_sh)
    pspecs = cm.param_pspecs(table, rules=rules, mesh=sizes)
    if data_axes:
        n_data = math.prod(sizes[a] for a in data_axes)
        mspecs = _zero1_pspecs(table, pspecs, data_axes, n_data)
    else:
        mspecs = pspecs
    opt_specs = AdamWState(step=(), mu=mspecs, nu=mspecs)
    return params_sh, opt_shapes, pspecs, opt_specs


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _model_flops(cache: Optional[Dict[str, list]], key: str, fn, *args,
                 **kwargs) -> flops_mod.FlopCount:
    """``traced_flops(fn, *args)``, read from and written to ``cache``
    (key -> [total, matmul_flops]) where one is given: the model FLOPs do
    not depend on the mesh."""
    if cache is not None and key in cache:
        return flops_mod.FlopCount(*cache[key])
    mf = flops_mod.traced_flops(fn, *args, **kwargs)
    if cache is not None:
        cache[key] = [float(mf), mf.matmul_flops]
    return mf


def _train_step(loss_fn, lr, mesh, bt, pspecs, opt_specs, has_bn=False,
                microbatches=1, accum=False):
    return steps_mod.make_train_step(
        loss_fn, cosine_schedule(lr, 100, 1000), has_bn=has_bn,
        microbatches=microbatches,
        accum_shardings=opt_specs.mu if accum else None,
        placement=steps_mod.TrainPlacement(mesh, bt, pspecs, opt_specs.mu))


def _grad_of(loss_fn):
    """``(params, batch) -> grads`` of ``loss_fn``'s loss, for tracing."""
    return lambda p, b: steps_mod.value_and_grad(loss_fn, p, b)[2]


def gather_model(params, pspecs, mesh):
    """Each leaf whole over "model": the dimensions its spec splits over
    "model" all-gathered (``parallel.gather_out``: the gradient comes back
    as this rank's piece)."""
    sizes = cm.mesh_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return params

    def one(t, spec):
        for d, e in enumerate(spec):
            if e == "model":
                t = par.gather_out(t, d, mesh.get_group("model"))
            elif "model" in cm._entry_axes(e):
                raise ValueError(f"spec {spec}: 'model' inside a tuple")
        return t
    return cm.map_with_specs(one, params, pspecs)


def _gathered(fn, pspecs, mesh):
    """``fn(params, *rest)`` on this rank's pieces, the "model"-split
    leaves all-gathered first (the module docstring)."""
    def run(params, *rest):
        return fn(gather_model(params, pspecs, mesh), *rest)
    return run


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch_id, shape_name, shape, mesh, overrides, flops_cache) -> Cell:
    key = f"{arch_id}:{shape_name}"
    from repro_torch.models import transformer as T
    mod = cfgreg.get_module(arch_id)
    sizes = cm.mesh_sizes(mesh)
    n_model = sizes.get("model", 1)
    bt = batch_axes_for(mesh, shape["global_batch"])
    # Overrides by replace, so the depth may be cut too (not only the
    # fields config() leaves to its caller).
    cfg = dataclasses.replace(mod.config(pad_heads_to=n_model),
                              **(overrides or {}))
    ref_cfg = mod.config(remat=False)                  # unpadded reference
    B, S = shape["global_batch"], shape["seq_len"]
    kind = shape["kind"]
    table = T.lm_param_table(cfg)
    rules = T.lm_rules(cfg)
    pspecs = cm.param_pspecs(table, rules=rules, mesh=sizes)
    params_sh = cm.param_shapes(table)
    ref_params = cm.param_shapes(T.lm_param_table(ref_cfg))
    i32 = torch.int32

    n_active = cfg.active_param_count() - cfg.vocab * cfg.d_model

    if kind == "train":
        params_sh, opt_shapes, pspecs, opt_specs = _opt_shapes_and_shardings(
            table, sizes, bt, rules=rules)
        step = _Lazy(lambda: _train_step(
            T.make_loss_fn(cfg, mesh, bt), 3e-4, mesh, bt, pspecs, opt_specs,
            microbatches=cfg.microbatch, accum=cfg.microbatch > 1))
        batch_sh = {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}
        batch_spec = {"tokens": (bt, None), "labels": (bt, None)}
        mf = _model_flops(flops_cache, key, _grad_of(T.make_loss_fn(ref_cfg)),
                          ref_params, batch_sh)
        return Cell(arch_id, shape_name, kind, step,
                    (params_sh, opt_shapes, batch_sh),
                    (pspecs, opt_specs, batch_spec),
                    donate_argnums=(0, 1),
                    model_flops=mf, six_nd=6.0 * n_active * B * S)

    if kind == "prefill":
        step = _Lazy(lambda: T.make_prefill(cfg, mesh, bt))
        toks = _sds((B, S), i32)
        mf = _model_flops(flops_cache, key, T.make_prefill(ref_cfg), ref_params, toks)
        return Cell(arch_id, shape_name, kind, step, (params_sh, toks),
                    (pspecs, (bt, None)), donate_argnums=(),
                    model_flops=mf, six_nd=2.0 * n_active * B * S)

    if kind == "decode":
        if cfg.decode_seq_shard:
            # Flash-decoding mode: heads replicated (no TP padding), KV
            # cache sequence-sharded over the model axis.
            cfg = dataclasses.replace(mod.config(pad_heads_to=1),
                                      **(overrides or {}))
            table = T.lm_param_table(cfg)
            pspecs = T.lm_param_specs(cfg, sizes, serving=True)
            params_sh = cm.param_shapes(table)
            cache_spec = T.seq_cache_pspecs(bt)
        else:
            cache_spec = T.cache_pspecs(cfg, bt)
        step = _Lazy(lambda: T.make_decode_step(cfg, mesh, bt))
        cache_sh = T.cache_shapes(cfg, B, S)
        toks = _sds((B, 1), i32)
        mf = _model_flops(flops_cache, key, T.make_decode_step(ref_cfg), ref_params,
                          T.cache_shapes(ref_cfg, B, S), toks)
        return Cell(arch_id, shape_name, kind, step,
                    (params_sh, cache_sh, toks),
                    (pspecs, cache_spec, (bt, None)),
                    donate_argnums=(1,),
                    model_flops=mf, six_nd=2.0 * n_active * B)

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Diffusion cells
# ---------------------------------------------------------------------------

def _diffusion_cell(arch_id, shape_name, shape, mesh, flops_cache) -> Cell:
    key = f"{arch_id}:{shape_name}"
    mod = cfgreg.get_module(arch_id)
    sizes = cm.mesh_sizes(mesh)
    B, R = shape["batch"], shape["img_res"]
    bt = batch_axes_for(mesh, shape["batch"])
    kind = shape["kind"]
    lat = R // 8
    steps_mult = 1 if kind == "train" else shape["steps"]
    f32, i32 = torch.float32, torch.int32
    img4 = (bt, None, None, None)

    if arch_id == "dit-l2":
        from repro_torch.models import dit as M
        cfg = mod.config()
        ref_cfg = mod.config(remat=False, dtype="float32")
        table = M.dit_param_table(cfg)
        ref_table = M.dit_param_table(ref_cfg)
        batch_sh = {"latents": _sds((B, lat, lat, 4), f32),
                    "timesteps": _sds((B,), i32), "labels": _sds((B,), i32),
                    "noise": _sds((B, lat, lat, 4), f32)}
        batch_spec = {"latents": img4, "timesteps": (bt,), "labels": (bt,),
                      "noise": img4}
        sample_args = ({"zt": _sds((B, lat, lat, 4), f32),
                        "t": _sds((B,), i32), "t_next": _sds((B,), i32),
                        "y": _sds((B,), i32)},
                       {"zt": img4, "t": (bt,), "t_next": (bt,), "y": (bt,)})
        names = ("zt", "t", "t_next", "y")
    else:  # unet-sdxl
        from repro_torch.models import unet as M
        cfg = mod.config(img_res=R)
        ref_cfg = mod.config(img_res=R, remat=False, dtype="float32")
        table = M.unet_param_table(cfg)
        ref_table = M.unet_param_table(ref_cfg)
        batch_sh = {"latents": _sds((B, lat, lat, 4), f32),
                    "timesteps": _sds((B,), i32),
                    "noise": _sds((B, lat, lat, 4), f32),
                    "context": _sds((B, cfg.ctx_len, cfg.ctx_dim), f32),
                    "pooled": _sds((B, cfg.ctx_dim), f32)}
        batch_spec = {"latents": img4, "timesteps": (bt,), "noise": img4,
                      "context": (bt, None, None), "pooled": (bt, None)}
        sample_args = ({"zt": _sds((B, lat, lat, 4), f32),
                        "t": _sds((B,), i32), "t_next": _sds((B,), i32),
                        "context": batch_sh["context"],
                        "pooled": batch_sh["pooled"]},
                       {"zt": img4, "t": (bt,), "t_next": (bt,),
                        "context": (bt, None, None), "pooled": (bt, None)})
        names = ("zt", "t", "t_next", "context", "pooled")

    pspecs = cm.param_pspecs(table, mesh=sizes)
    params_sh = cm.param_shapes(table)
    n_params = cm.param_count(table)

    if kind == "train":
        params_sh, opt_shapes, pspecs, opt_specs = _opt_shapes_and_shardings(
            table, sizes, bt)
        step = _Lazy(lambda: _train_step(
            _gathered(M.make_loss_fn(cfg, mesh, bt, img_res=R), pspecs, mesh),
            1e-4, mesh, bt, pspecs, opt_specs))
        mf = _model_flops(
            flops_cache, key, _grad_of(M.make_loss_fn(ref_cfg, None, None, img_res=R)),
            cm.param_shapes(ref_table), batch_sh)
        six_nd = 6.0 * n_params * B * (lat // 2) ** 2 \
            if arch_id == "dit-l2" else None
        return Cell(arch_id, shape_name, kind, step,
                    (params_sh, opt_shapes, batch_sh),
                    (pspecs, opt_specs, batch_spec),
                    donate_argnums=(0, 1), model_flops=mf, six_nd=six_nd)

    def sample(make, c, m):
        fn = make(c, m, bt if m is not None else None, img_res=R)
        return lambda params, a: fn(params, *(a[k] for k in names))

    step = _Lazy(lambda: _gathered(sample(M.make_sample_step, cfg, mesh),
                                   pspecs, mesh))
    args_sh, args_spec = sample_args
    mf = _model_flops(flops_cache, key, sample(M.make_sample_step, ref_cfg, None),
                      cm.param_shapes(ref_table), args_sh)
    six_nd = 2.0 * n_params * 2 * B * (lat // 2) ** 2 \
        if arch_id == "dit-l2" else None
    return Cell(arch_id, shape_name, kind, step, (params_sh, args_sh),
                (pspecs, args_spec), donate_argnums=(), model_flops=mf,
                six_nd=six_nd, steps_multiplier=steps_mult,
                note=f"one denoise step; totals scale x{steps_mult}")


# ---------------------------------------------------------------------------
# Vision cells
# ---------------------------------------------------------------------------

def _vision_cell(arch_id, shape_name, shape, mesh, flops_cache) -> Cell:
    key = f"{arch_id}:{shape_name}"
    mod = cfgreg.get_module(arch_id)
    sizes = cm.mesh_sizes(mesh)
    B, R = shape["batch"], shape["img_res"]
    bt = batch_axes_for(mesh, B)
    kind = shape["kind"]
    has_bn = arch_id in ("resnet-50", "efficientnet-b7")

    if arch_id == "vit-l16":
        from repro_torch.models import vit as M
        cfg = mod.config()
        table = M.vit_param_table(cfg, img_res=R)
        ref_cfg = mod.config(remat=False, dtype="float32")
        ref_table = M.vit_param_table(ref_cfg, img_res=R)
        make_fwd = lambda c, trn: M.make_forward(c)  # noqa: E731
    elif arch_id == "resnet-50":
        from repro_torch.models import resnet as M
        cfg = ref_cfg = mod.config()
        table = ref_table = M.resnet_param_table(cfg)
        make_fwd = lambda c, trn: (  # noqa: E731
            lambda p, x: M.make_forward(c, training=trn)(p, x)[0])
    elif arch_id == "efficientnet-b7":
        from repro_torch.models import efficientnet as M
        cfg = ref_cfg = mod.config()
        table = ref_table = M.efficientnet_param_table(cfg)
        make_fwd = lambda c, trn: (  # noqa: E731
            lambda p, x: M.make_forward(c, training=trn)(p, x)[0])
    else:  # convnext-b
        from repro_torch.models import convnext as M
        cfg = mod.config()
        ref_cfg = mod.config(dtype="float32")
        table = M.convnext_param_table(cfg)
        ref_table = M.convnext_param_table(ref_cfg)
        make_fwd = lambda c, trn: M.make_forward(c)  # noqa: E731

    pspecs = cm.param_pspecs(table, mesh=sizes)
    params_sh = cm.param_shapes(table)
    images = _sds((B, R, R, 3), torch.float32)
    labels = _sds((B,), torch.int32)

    if kind == "train":
        params_sh, opt_shapes, pspecs, opt_specs = _opt_shapes_and_shardings(
            table, sizes, bt)
        step = _Lazy(lambda: _train_step(
            _gathered(M.make_loss_fn(cfg, mesh, bt), pspecs, mesh), 1e-3, mesh,
            bt, pspecs, opt_specs, has_bn=has_bn))
        batch_sh = {"images": images, "labels": labels}
        batch_spec = {"images": (bt, None, None, None), "labels": (bt,)}
        mf = _model_flops(flops_cache, key, _grad_of(M.make_loss_fn(ref_cfg)),
                          cm.param_shapes(ref_table), batch_sh)
        return Cell(arch_id, shape_name, kind, step,
                    (params_sh, opt_shapes, batch_sh),
                    (pspecs, opt_specs, batch_spec),
                    donate_argnums=(0, 1), model_flops=mf, six_nd=None)

    step = _Lazy(lambda: _gathered(torch.no_grad()(make_fwd(cfg, False)),
                                   pspecs, mesh))
    mf = _model_flops(flops_cache, key, make_fwd(ref_cfg, False),
                      cm.param_shapes(ref_table), images)
    return Cell(arch_id, shape_name, "serve", step, (params_sh, images),
                (pspecs, (bt, None, None, None)),
                donate_argnums=(), model_flops=mf, six_nd=None)


# ---------------------------------------------------------------------------
# Dehaze cells (the paper's own pipeline)
# ---------------------------------------------------------------------------

def _dehaze_cell(arch_id, shape_name, shape, mesh, overrides, flops_cache) -> Cell:
    from repro_torch.core import (AtmoState, init_atmo_state, make_dehaze_step,
                                  make_sharded_dehaze_step)
    mod = cfgreg.get_module(arch_id)
    cfg = mod.config(kernel_mode="ref", **(overrides or {}))
    B, H, W = shape["batch"], shape["height"], shape["width"]
    bt = batch_axes_for(mesh, B)
    n_model = cm.mesh_sizes(mesh).get("model", 1)
    height_axis = "model" if H % n_model == 0 else None
    step = _Lazy(lambda: make_sharded_dehaze_step(
        cfg, mesh, batch_axes=bt or (), height_axis=height_axis))

    frames = _sds((B, H, W, 3), torch.float32)
    ids = _sds((B,), torch.int32)
    state_sh = flops_mod.to_meta(init_atmo_state("cpu"))
    fspec = (bt if bt else None, height_axis, None)
    ispec = (bt if bt else None,)
    state_spec = AtmoState(A=(), last_update=(), initialized=())

    key = f"{arch_id}:{shape_name}:{sorted((overrides or {}).items())}"
    mf = _model_flops(flops_cache, key, make_dehaze_step(cfg, device="cpu"), frames,
                      ids, state_sh, device="cpu")
    return Cell(arch_id, shape_name, "dehaze", step, (frames, ids, state_sh),
                (fspec, ispec, state_spec),
                donate_argnums=(), model_flops=mf, six_nd=None,
                note=f"height_axis={height_axis}")


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh,
               overrides: Optional[Dict] = None,
               flops_cache: Optional[Dict[str, list]] = None) -> Cell:
    """``mesh``: a ``DeviceMesh`` (or, to read the placements only, any
    object with ``mesh_dim_names`` and ``size(i)``). ``overrides``:
    config-field overrides for perf iteration (e.g. {"seq_shard": True});
    applied to the built config only — the reference MODEL_FLOPS trace
    stays at the paper-faithful baseline so the useful-FLOPs ratio remains
    comparable across variants. ``flops_cache``: model FLOPs by cell,
    read and filled (a caller that builds a cell on several meshes)."""
    skip = cfgreg.cell_skip_reason(arch_id, shape_name)
    if skip:
        raise CellSkip(skip)
    shape = cfgreg.shapes_for(arch_id)[shape_name]
    family = cfgreg.get_module(arch_id).FAMILY
    if family == "lm":
        cell = _lm_cell(arch_id, shape_name, shape, mesh, overrides, flops_cache)
    elif family == "dehaze":
        cell = _dehaze_cell(arch_id, shape_name, shape, mesh, overrides,
                            flops_cache)
    elif overrides:
        raise ValueError(f"overrides unsupported for family {family}")
    elif family == "diffusion":
        cell = _diffusion_cell(arch_id, shape_name, shape, mesh, flops_cache)
    elif family == "vision":
        cell = _vision_cell(arch_id, shape_name, shape, mesh, flops_cache)
    else:
        raise ValueError(family)
    cell.in_shardings = tuple(_normalize(t) for t in cell.in_shardings)
    return cell


def _normalize(tree):
    """Spec entries as ``PartitionSpec`` keeps them: a tuple of one axis
    is that axis."""
    def one(spec: Tuple) -> Tuple:
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
    if cm.is_spec(tree):
        return one(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _normalize(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _normalize(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_normalize(v) for v in tree))
    raise TypeError(f"not a spec tree: {tree!r}")


__all__ = ["Cell", "CellSkip", "build_cell", "placements", "gather_model"]
