"""Analytic MODEL_FLOPS: a dispatch-mode counter of ideal compute.

The port's counterpart of the reference's ``launch/flops.py``, which walks
a jaxpr. PyTorch has no jaxpr; this module replaces the walker with a
``TorchDispatchMode`` of its own that runs ``fn`` on ``meta`` tensors
(nothing is allocated, nothing is computed; fake CPU tensors for a step
that moves its inputs to the CPU) and counts each ATen op as it is
dispatched:

  - ``mm``/``bmm``/``addmm``/``baddbmm`` (what ``einsum`` and ``@`` lower
    to, forward and backward): 2 * batch * M * N * K, plus one an output
    element for the ``add`` of ``addmm``/``baddbmm``;
  - ``convolution`` (and each product of ``convolution_backward``): 2 *
    out * k_spatial * Cin/groups, the reference's ``conv_general_dilated``
    rule;
  - each op tagged pointwise: 1 a output element (copies none); each reduction
    (``sum``, ``amax``, ``mean``, ...) and ``cumsum``: 1 an input element,
    as the reference's ``ELEMENTWISE``/``REDUCTIONS``; the fused
    ``softmax``/``log_softmax``/norm ops 5 an element (the max, subtract,
    exp, sum and divide the reference counts apart);
  - pooling and the box filters' ``avg_pool2d``: 1 an output element for
    each row and each column of the window, the reference's separable
    ``reduce_window`` passes;
  - a Python loop over layers is counted by running it, which takes the
    place of the reference's scan multiplier, and only the branch that
    runs is counted where the reference's ``lax.cond`` counts the larger.

:func:`traced_flops` returns the total, as a float, with the product and
convolution part as ``.matmul_flops``: the part the two packages must
agree on exactly where they compute the same products.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_FIVE = {aten._softmax, aten._log_softmax, aten.native_layer_norm,
         aten.native_group_norm, aten._softmax_backward_data,
         aten._log_softmax_backward_data, aten.native_layer_norm_backward,
         aten.native_group_norm_backward, aten.logsumexp}
_CUMULATIVE = {aten.cumsum, aten.cumprod, aten.cummax, aten.cummin}
_POOLS = {aten.max_pool2d_with_indices, aten.avg_pool2d}
_POOL_GRADS = {aten.max_pool2d_with_indices_backward, aten.avg_pool2d_backward}
# Copies move data and compute nothing (``clone`` is tagged pointwise).
_MOVES = {aten.clone, aten.copy, aten.copy_, aten._to_copy}


class FlopCount(float):
    """A FLOP total (the float's value) with its product and convolution
    part, ``matmul_flops``."""

    def __new__(cls, total: float, matmul_flops: float):
        out = float.__new__(cls, total)
        out.matmul_flops = float(matmul_flops)
        return out


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _conv_flops(w_shape, out_shape) -> float:
    """2 * out * k_spatial * Cin/groups (the OIHW weight's I is Cin/groups)."""
    k_spatial = math.prod(w_shape[2:])
    return 2.0 * math.prod(out_shape) * k_spatial * w_shape[1]


class FlopCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (the module
    docstring): ``total`` and ``matmul``."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.matmul = 0.0

    def _product(self, flops: float) -> None:
        self.matmul += flops
        self.total += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _kind_of(func)
        if kind is _NONE:
            return out
        if kind == "mm" or kind == "addmm":
            a, b = (args[0], args[1]) if kind == "mm" else (args[1], args[2])
            self._product(2.0 * a.shape[0] * a.shape[1] * b.shape[1])
            if kind == "addmm":
                self.total += _numel(out)
        elif kind == "bmm" or kind == "baddbmm":
            a, b = (args[0], args[1]) if kind == "bmm" else (args[1], args[2])
            self._product(2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2])
            if kind == "baddbmm":
                self.total += _numel(out)
        elif kind == "conv":
            self._product(_conv_flops(args[1].shape, out.shape))
        elif kind == "conv_bwd":
            mask = args[10] if len(args) > 10 else kwargs.get("output_mask",
                                                               (True,) * 3)
            one = _conv_flops(args[2].shape, args[0].shape)
            self._product(one * (int(bool(mask[0])) + int(bool(mask[1]))))
        elif kind == "five":
            self.total += 5.0 * _numel(args[0])
        elif kind == "input":
            self.total += _numel(args[0])
        elif kind in ("pool", "pool_bwd"):
            k = args[1] if kind == "pool" else args[2]      # the window
            window = list(k) if isinstance(k, (list, tuple)) else [k]
            window = window * 2 if len(window) == 1 else window
            self.total += _numel(out[0] if isinstance(out, tuple) else out) \
                * sum(window)
        elif kind == "output":
            self.total += _numel(out[0] if isinstance(out, (tuple, list)) else out)
        return out


_NONE = "none"
_KINDS: dict = {}          # op overload -> how it is counted, once an op
_PACKET_KINDS = {aten.mm: "mm", aten.addmm: "addmm", aten.bmm: "bmm",
                 aten.baddbmm: "baddbmm", aten.convolution: "conv",
                 aten.convolution_backward: "conv_bwd"}


def _kind_of(func) -> str:
    packet = func.overloadpacket
    if func.namespace != "aten":
        return _NONE
    if packet in _PACKET_KINDS:
        return _PACKET_KINDS[packet]
    if packet in _FIVE:
        return "five"
    if packet in _CUMULATIVE:
        return "input"
    if packet in _POOLS:
        return "pool"
    if packet in _POOL_GRADS:
        return "pool_bwd"
    if packet in _MOVES:
        return _NONE
    if torch.Tag.pointwise in func.tags:
        return "output"
    if torch.Tag.reduction in func.tags:
        return "input"
    return _NONE


def map_tensors(fn, tree: Any) -> Any:
    """``fn`` over every tensor of ``tree`` (dicts, lists, tuples, named
    tuples and dataclasses such as ``AtmoState``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def to_meta(tree: Any) -> Any:
    """Every tensor of ``tree`` as a ``meta`` tensor of its shape and
    dtype."""
    return map_tensors(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                             device="meta"), tree)


def traced_flops(fn, *args, device: str = "meta", **kwargs) -> FlopCount:
    """FLOPs of ``fn(*args, **kwargs)`` by :class:`FlopCounter`, run on
    tensors of the shapes and dtypes of ``args``' tensors that hold no
    data: ``meta`` tensors, or with ``device="cpu"`` fake CPU tensors
    (``FakeTensorMode``), for a step that moves its inputs to the CPU."""
    counter = FlopCounter()
    if device == "meta":
        args = to_meta(args)
        with counter:
            fn(*args, **kwargs)
        return FlopCount(counter.total, counter.matmul)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = map_tensors(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                 device=device), args)
        with counter:
            fn(*args, **kwargs)
    return FlopCount(counter.total, counter.matmul)


__all__ = ["FlopCount", "FlopCounter", "map_tensors", "to_meta",
           "traced_flops"]
