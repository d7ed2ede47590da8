"""Generic train step builder shared by all architectures (the port's copy
of the JAX package's ``models/steps.py``).

Gradients come from ``torch.autograd.grad`` over the param leaves; a leaf
the loss does not reach (BatchNorm's running ``mean``/``var``) gets a zero
gradient, as ``jax.value_and_grad`` gives it, and it enters the clip's
global norm and AdamW's moments like any other.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import common as cm
from repro_torch.optim import AdamWState, adamw_update, global_norm
from repro_torch.optim.adamw import _clip_scale
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


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
                    weight_decay: float = 0.1, microbatches: int = 1):
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
    """

    def apply_update(params, opt_state: AdamWState, grads, metrics, loss):
        gnorm = global_norm(grads)
        lr = lr_schedule(opt_state.step)
        new_params, new_opt = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay,
            grad_scale=_clip_scale(gnorm, grad_clip))
        if has_bn:
            new_params = cm.merge_bn_stats(new_params, metrics.pop("bn_params"))
        out_metrics = dict(metrics)
        out_metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return new_params, new_opt, out_metrics

    if microbatches <= 1:
        def train_step(params, opt_state: AdamWState, batch):
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
            return apply_update(params, opt_state, grads, metrics, loss)
        return train_step

    if has_bn:
        raise ValueError("microbatching + BN stat merge not supported")

    def train_step(params, opt_state: AdamWState, batch):
        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        mb = tree_map(lambda x: split(torch.as_tensor(x)), batch)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        loss_sum = 0.0
        for i in range(microbatches):
            loss, metrics, grads = value_and_grad(
                loss_fn, params, tree_map(lambda x: x[i], mb))
            tree_map(lambda a, g: a.add_(g.float()), gsum, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g.div_(microbatches), gsum)
        return apply_update(params, opt_state, grads, metrics,
                            loss_sum / microbatches)

    return train_step
