"""Explicit collectives of the LM's model axis and of the batch axes.

The port's counterpart of the reference's ``shard_map`` bodies and of the
collectives GSPMD derives from its shardings: each rank holds its own
shards (``common.shard_params``) and calls ``torch.distributed`` on the
``DeviceMesh``'s groups, ``mesh.get_group("model")`` and the batch axes'
group (``core.pipeline.batch_group``).

Gradients follow one rule (Megatron's): the gradient a rank holds for a
tensor replicated over the model axis is the whole gradient, the same on
every rank; for a sharded tensor it is the gradient of the rank's shard.
Each op below names its backward pass so that the rule holds:

  ==================  ============================  ============================
  op                  forward                       backward
  ==================  ============================  ============================
  :func:`reduce`      all-reduce (sum)              identity
  :func:`enter`       identity                      all-reduce (sum)
  :func:`gather_in`   all-gather along a dim        reduce-scatter
  :func:`scatter_out` reduce-scatter along a dim    all-gather
  :func:`split`       this rank's chunk of a dim    all-gather
  :func:`gather_out`  all-gather along a dim        this rank's chunk
  :func:`all_to_all`  all-to-all (equal chunks)     all-to-all
  :func:`mean_model`  all-reduce / n                gradient / n
  :func:`mean_batch`  all-reduce / n                identity
  :func:`mean_of_shards` all-reduce / n             all-reduce / n
  :func:`scale_grad`  identity                      gradient * s
  ==================  ============================  ============================

``enter`` takes a replicated tensor into a region where each rank computes
only a part (its heads, its experts, its vocab, its tokens): a replicated
parameter used there (a norm's scale on sequence-sharded activations, the
router on this rank's tokens, a kv projection that a rank uses only some
heads of) goes through it, so its gradient is summed over the model axis
in the backward pass and comes out whole. ``mean_batch`` has an identity
backward because the train step means the gradients over the batch axes.

Gloo takes each of these collectives on CUDA tensors too (checked on an
H100 with torch 2.11), so two ranks can share one card over gloo.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous ``x``."""
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    dim = dim % x.dim()
    return _all_gather0(x.movedim(dim, 0), group).movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's chunk of ``dim``."""
    dim = dim % x.dim()
    return _reduce_scatter0(x.movedim(dim, 0), group).movedim(0, dim)


def _live_axes(mesh, axes):
    names = tuple(mesh.mesh_dim_names)
    return [a for a in axes if mesh.size(names.index(a)) > 1]


def all_gather_axes(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """Every rank's ``x`` over the mesh ``axes``' groups, concatenated
    row-major along ``dim`` (the last axis gathered first), as JAX tiles
    a dimension over a tuple of axes."""
    for a in reversed(_live_axes(mesh, axes)):
        x = all_gather_dim(x, dim, mesh.get_group(a))
    return x


def reduce_scatter_axes(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh ``axes``' groups, this rank's
    row-major chunk of ``dim`` (one reduce-scatter an axis, the first axis
    first)."""
    for a in _live_axes(mesh, axes):
        x = reduce_scatter_dim(x, dim, mesh.get_group(a))
    return x


def all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """Equal chunks of axis 0 exchanged: chunk i goes to rank i, and the
    result holds rank j's chunk for this rank at place j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def chunk_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


# ---------------------------------------------------------------------------
# Autograd ops (the table in the module docstring)
# ---------------------------------------------------------------------------

class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ScatterOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return chunk_of(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.dim, ctx.group).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_single(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_single(g, ctx.group), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        n = dist.get_world_size(group)
        return all_reduce_(x.contiguous().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


class _MeanOfShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        return all_reduce_(x.contiguous().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return all_reduce_(g.contiguous().clone(), ctx.group) / n, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def reduce(x, group):
    return _Reduce.apply(x, group)


def enter(x, group):
    return _Enter.apply(x, group)


def gather_in(x, dim: int, group):
    return _GatherIn.apply(x, dim, group)


def scatter_out(x, dim: int, group):
    return _ScatterOut.apply(x, dim, group)


def split(x, dim: int, group):
    return _Split.apply(x, dim, group)


def gather_out(x, dim: int, group):
    return _GatherOut.apply(x, dim, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


def mean_model(x, group):
    return _Mean.apply(x, group, 1.0 / dist.get_world_size(group))


def mean_batch(x, group: Optional[object]):
    """The mean of ``x`` over the batch axes' group (``None``: ``x``)."""
    if group is None:
        return x
    return _Mean.apply(x, group, 1.0)


def mean_of_shards(x, group):
    """The mean over the batch axes' group of a statistic each rank takes
    over its shard (equal shards): the whole batch's statistic, as GSPMD
    computes the reference's. Its backward sums every rank's gradient
    (each rank's loss reads it) and divides by the group's size."""
    return _MeanOfShards.apply(x, group)


def scale_grad(x, s: float):
    return _ScaleGrad.apply(x, s)


__all__ = ["all_reduce_", "all_gather_dim", "reduce_scatter_dim",
           "all_gather_axes", "reduce_scatter_axes",
           "all_to_all_single", "chunk_of", "reduce", "enter", "gather_in",
           "scatter_out", "split", "gather_out", "all_to_all", "mean_model",
           "mean_batch", "mean_of_shards", "scale_grad"]
