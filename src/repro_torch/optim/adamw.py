"""AdamW with decoupled weight decay, global-norm clipping, schedules.

The port's copy of the JAX package's ``optim/adamw.py``, over the port's
pytrees (:mod:`repro_torch.tree`). :class:`AdamWState` is a named tuple
``(step, mu, nu)``: it flattens in that field order, with paths ``.step``,
``.mu['a']``, ..., as the reference's registered dataclass does, so a
checkpoint of ``{"params", "opt"}`` loads in either package.

``step`` is an int32 0-d tensor on the params' device and the schedules
take and return tensors, so a training step never waits for the host.

:func:`adamw_update` writes the new params and moments into the tensors
it is given (the returned trees hold the same tensors): a training loop
passes them on, and a second copy of the optimizer state would not fit
beside a large model. It walks each leaf in pieces of :data:`CHUNK`
elements, so its float32 temporaries stay a piece's size whatever the
leaf's.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

CHUNK = 1 << 24          # elements of a leaf updated (or summed) at a time

LrLike = Union[torch.Tensor, float]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any             # first moment, same structure as params (float32)
    nu: Any             # second moment


def adamw_init(params: Any) -> AdamWState:
    """Zero float32 moments beside each leaf, step 0 on the params' device
    (the CPU for a tree without leaves)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _pieces(t: torch.Tensor):
    """The flat view of a contiguous ``t`` in :data:`CHUNK`-element
    slices (views: writing one writes ``t``)."""
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    return sum(c.float().square().sum() for c in _pieces(t.contiguous()))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, in flatten order, of each leaf's float32 sum of
    squares."""
    total = sum((_sum_squares(l) for l in tree_leaves(tree)),
                torch.zeros((), dtype=torch.float32))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(grads * min(1, max_norm / max(norm, 1e-12)), norm)``; the clipped
    leaves are float32, as the reference's product with its float32 scale
    promotes them."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_update(grads: Any, state: AdamWState, params: Any, lr: LrLike,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 decay_mask: Optional[Callable[[str], bool]] = None,
                 grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step. Returns (new_params, new_state).

    Consumes ``params``, ``state.mu`` and ``state.nu``: the new values are
    written into those (contiguous) tensors, and the returned trees hold
    them. ``decay_mask(path)`` -- True to apply weight decay to the leaf
    at that ``keystr`` path (such as ``"['layers']['wq']"``); by default
    every leaf with ndim >= 2 decays. ``grad_scale`` multiplies each
    gradient in float32 first: the train step's clip, without a float32
    copy of every gradient at once.
    """
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    flat, treedef = tree_flatten_with_path(params)
    gs, ms, vs = tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
    if not len(flat) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"{len(flat)} params, {len(gs)} grads, {len(ms)} "
                         f"and {len(vs)} moments")
    for (path, p), g, m, v in zip(flat, gs, ms, vs):
        do_decay = decay_mask(path) if decay_mask is not None else p.ndim >= 2
        g = g.reshape(p.shape)
        g_pieces = (g.view(-1) if g.is_contiguous() else g.reshape(-1)).split(CHUNK)
        for pc, gc, mc, vc in zip(_pieces(p), g_pieces, _pieces(m), _pieces(v)):
            gc = gc.float()
            if grad_scale is not None:
                gc = gc * grad_scale
            mc.copy_(b1 * mc + (1.0 - b1) * gc)
            vc.copy_(b2 * vc + (1.0 - b2) * gc.square())
            delta = (mc / c1) / (torch.sqrt(vc / c2) + eps)
            p32 = pc.float()
            if do_decay:
                delta = delta + weight_decay * p32
            pc.copy_((p32 - lr * delta).to(pc.dtype))
    return (tree_unflatten(treedef, [p for _, p in flat]),
            AdamWState(step=step, mu=state.mu, nu=state.nu))


def cosine_schedule(base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``lr(step)``: linear warmup from 0, then a cosine down to
    ``min_ratio * base_lr``; a float32 0-d tensor on the step's device,
    chosen by ``torch.where`` (no host branch)."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1.0 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr
