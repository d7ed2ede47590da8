"""Generic train step builder shared by all architectures (the port's copy
of the JAX package's ``models/steps.py``).

Gradients come from ``torch.autograd.grad`` over the param leaves; a leaf
the loss does not reach (BatchNorm's running ``mean``/``var``) gets a zero
gradient, as ``jax.value_and_grad`` gives it, and it enters the clip's
global norm and AdamW's moments like any other.

Sharded training (:class:`TrainPlacement`) is what GSPMD gives the
reference's step from its shardings, as explicit collectives: each rank
holds its param pieces (``param_specs``) and its batch shard; the
gradients are meaned over the batch axes' group; AdamW's moments are
ZeRO-1 pieces (``moment_specs``: the param spec plus the batch axes on
the first unsharded dimension they divide, ``launch.cells._zero1_pspecs``),
so a leaf's gradient is reduce-scattered over the batch axes onto its
piece, the piece updated, and the new params all-gathered back over them.
The clip's global norm is taken over the whole tree across ranks: each
rank's sum of squares of what it holds, divided by the ranks that hold the
same piece, summed over the world. Gradients of leaves replicated on
"model" but reached by sharded activations (the norms and the router
under sequence sharding, a kv projection whose heads a rank uses only
some of) are summed over "model" by the forward's ``parallel.enter`` in
the backward pass, so they come out whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import common as cm
from repro_torch.models import parallel as par
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.optim.adamw import _clip_scale, _sum_squares
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainPlacement:
    """Where a sharded train step's state lives: the ``DeviceMesh``, the
    batch axes (``launch.mesh.batch_axes_for``; None: the batch is
    replicated), and per leaf the mesh-axis tuples of the params and of
    AdamW's moments (``param_pspecs``' form)."""
    mesh: Any
    batch_axes: Optional[Tuple[str, ...]]
    param_specs: Any
    moment_specs: Any


class _Leaf:
    """One leaf's placement: its ZeRO-1 dimension (where the moment spec
    adds the batch axes), those axes, and how many ranks hold each piece
    of what this rank updates."""

    def __init__(self, ps: Tuple, ms: Tuple, sizes, world: int):
        ndim = max(len(ps), len(ms))
        ps = tuple(ps) + (None,) * (ndim - len(ps))
        ms = tuple(ms) + (None,) * (ndim - len(ms))
        self.dim, self.axes = None, ()
        for d, (a, b) in enumerate(zip(ps, ms)):
            if a != b:
                if a is not None or self.dim is not None:
                    raise ValueError(f"moment spec {ms} is not param spec {ps} "
                                     "plus one ZeRO-1 dimension")
                self.dim, self.axes = d, cm._entry_axes(b)
        named = {a for e in ms for a in cm._entry_axes(e)}
        self.replicas = world // math.prod(sizes[a] for a in named)


_WHOLE = _Leaf((), (), {}, 1)       # one device: the leaf is its own piece


def _leaves(pl: "TrainPlacement"):
    """A :class:`_Leaf` a param, in flatten order."""
    sizes = cm.mesh_sizes(pl.mesh)
    world = math.prod(sizes.values())
    return [_Leaf(ps, ms, sizes, world) for ps, ms in zip(
        tree_leaves(pl.param_specs, is_leaf=cm.is_spec),
        tree_leaves(pl.moment_specs, is_leaf=cm.is_spec))]


def _piece(t, info: _Leaf, mesh):
    """This rank's ZeRO-1 piece of a param-local tensor ``t``."""
    if info.dim is None:
        return t
    return cm.local_shard(t, (None,) * info.dim + (info.axes,), mesh)


def _detach(tree: Any) -> Any:
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
                    tree)


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: grads in the params' tree and dtypes, zeros where the loss
    does not depend on a leaf; loss and metrics detached."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _detach(metrics), tree_unflatten(treedef, grads)


def make_train_step(loss_fn: Callable, lr_schedule: Callable,
                    grad_clip: float = 1.0, has_bn: bool = False,
                    weight_decay: float = 0.1, microbatches: int = 1,
                    accum_shardings: Any = None,
                    placement: Optional[TrainPlacement] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The step consumes ``params`` and ``opt_state``: AdamW writes the new
    values into their tensors (:func:`repro_torch.optim.adamw_update`),
    and the returned trees hold those tensors (BatchNorm's running stats
    excepted, see below). The values equal the reference's.

    The learning rate is ``lr_schedule(opt_state.step)``, read before the
    step counts up, so under warmup the first update has lr 0.

    BN-carrying models return their refreshed running stats in
    ``metrics["bn_params"]``; those leaves (detached) overwrite the
    optimizer's output (they receive zero gradient, so this is the only
    path that moves them).

    ``microbatches > 1`` = gradient accumulation: the global batch splits
    along its leading dim, gradients add up in float32 and are divided by
    the count; the loss is the mean of the microbatches' losses and the
    other metrics are the last microbatch's. It does not combine with
    ``has_bn``.

    ``placement``: the sharded step (the module docstring): ``params``
    and ``batch`` are this rank's pieces, ``opt_state``'s moments its
    ZeRO-1 pieces. ``accum_shardings`` (the reference's argument; with
    ``placement`` only) places the float32 accumulators under
    microbatches as moment-like specs: each microbatch's gradients are
    reduce-scattered onto them, so they take a piece's bytes. Without
    ``placement`` every leaf is one whole piece and no collective runs.
    """
    if has_bn and microbatches > 1:
        raise ValueError("microbatching + BN stat merge not supported")
    accum = accum_shardings is not None
    if accum and placement is None:
        raise ValueError("accum_shardings places the accumulators of a "
                         "sharded step: pass placement")
    if accum and (tree_leaves(accum_shardings, is_leaf=cm.is_spec)
                  != tree_leaves(placement.moment_specs, is_leaf=cm.is_spec)):
        raise ValueError("accum_shardings must be the moments' specs (the "
                         "reference's cells pass opt_specs.mu)")
    mesh = bgroup = infos = None
    world = n_b = 1
    if placement is not None:
        from repro_torch.core.pipeline import batch_group
        mesh = placement.mesh
        sizes = cm.mesh_sizes(mesh)
        world = math.prod(sizes.values())
        if placement.batch_axes:
            n_b = math.prod(sizes[a] for a in placement.batch_axes)
        if n_b > 1:
            bgroup = batch_group(mesh, placement.batch_axes)[0]
        infos = _leaves(placement)

    def batch_mean(t: torch.Tensor) -> torch.Tensor:
        if bgroup is None:
            return t
        return par.all_reduce_(t.contiguous(), bgroup) / n_b

    def onto_piece(g: torch.Tensor, info: _Leaf) -> torch.Tensor:
        """``g`` (a param piece's gradient, this rank's batch) summed over
        the batch axes onto the piece this rank updates."""
        if info.dim is not None:
            return par.reduce_scatter_axes(g, info.dim, info.axes, mesh)
        return g if bgroup is None else par.all_reduce_(g.contiguous(), bgroup)

    def apply_update(params, opt_state: AdamWState, g_pieces, metrics, loss,
                     leaf_infos):
        flat, treedef = tree_flatten(params)
        sq = sum((_sum_squares(g) / info.replicas
                  for g, info in zip(g_pieces, leaf_infos)),
                 torch.zeros((), dtype=torch.float32, device=flat[0].device))
        if world > 1:
            sq = par.all_reduce_(sq.reshape(1), dist.group.WORLD).reshape(())
        gnorm = torch.sqrt(sq)
        lr = lr_schedule(opt_state.step)
        p_pieces = [p if info.dim is None else _piece(p, info, mesh).contiguous()
                    for p, info in zip(flat, leaf_infos)]
        new_pieces, new_opt = adamw_update(
            tree_unflatten(treedef, g_pieces), opt_state,
            tree_unflatten(treedef, p_pieces), lr, weight_decay=weight_decay,
            grad_scale=_clip_scale(gnorm, grad_clip))
        for p, new, info in zip(flat, tree_leaves(new_pieces), leaf_infos):
            if info.dim is not None:
                p.copy_(par.all_gather_axes(new, info.dim, info.axes, mesh))
        new_params = tree_unflatten(treedef, flat)
        if has_bn:
            new_params = cm.merge_bn_stats(new_params, metrics.pop("bn_params"))
        out_metrics = {k: batch_mean(v) if (isinstance(v, torch.Tensor)
                                            and v.dim() == 0 and v.is_floating_point())
                       else v for k, v in metrics.items()}
        out_metrics.update(loss=batch_mean(loss), grad_norm=gnorm, lr=lr)
        return new_params, new_opt, out_metrics

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])

    def train_step(params, opt_state: AdamWState, batch):
        leaf_infos = infos or [_WHOLE] * len(tree_leaves(params))
        if microbatches <= 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
            g_pieces = [onto_piece(g, info) for g, info in
                        zip(tree_leaves(grads), leaf_infos)]
            if n_b > 1:
                g_pieces = [g / n_b for g in g_pieces]
            return apply_update(params, opt_state, g_pieces, metrics, loss,
                                leaf_infos)
        mb = tree_map(lambda x: split(torch.as_tensor(x)), batch)
        gsum, loss_sum = None, 0.0
        for i in range(microbatches):
            loss, metrics, grads = value_and_grad(
                loss_fn, params, tree_map(lambda x: x[i], mb))
            gs = [par.reduce_scatter_axes(g.float(), a.dim, a.axes, mesh)
                  if accum and a.dim is not None else g.float()
                  for g, a in zip(tree_leaves(grads), leaf_infos)]
            gsum = gs if gsum is None else [a.add_(g) for a, g in zip(gsum, gs)]
            loss_sum = loss_sum + loss
        g_pieces = [(g if accum and info.dim is not None
                     else onto_piece(g, info)).div_(n_b * microbatches)
                    for g, info in zip(gsum, leaf_infos)]
        return apply_update(params, opt_state, g_pieces, metrics,
                            loss_sum / microbatches, leaf_infos)

    return train_step


def init_opt_state(params: Any, placement: TrainPlacement) -> AdamWState:
    """Zero float32 moments of this rank's ZeRO-1 pieces of ``params``
    (its param pieces), step 0 on their device."""
    from repro_torch.optim import adamw_init
    flat, treedef = tree_flatten(params)
    pieces = [_piece(p, i, placement.mesh) for p, i in zip(flat, _leaves(placement))]
    return adamw_init(tree_unflatten(treedef, pieces))
