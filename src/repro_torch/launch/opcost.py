"""Per-rank cost model from one step's op record: the port's counterpart of
the reference's ``launch/hlocost.py``.

The reference parses the per-device HLO that XLA's SPMD partitioner
writes. The port has no HLO: ``dryrun.py`` runs one rank's step on fake
tensors under :class:`OpRecorder`, a ``TorchDispatchMode`` that writes one
entry an ATen op, and :func:`cost_from_ops` turns the record into the same
:class:`HloCost` fields:

  * ``flops``: products and convolutions, per rank (the MXU terms of the
    reference; :class:`repro_torch.launch.flops.FlopCounter`'s rules).
    Elementwise ops ride along with the memory term, as there.
  * ``traffic_bytes``: each op's operand bytes plus output bytes. Views
    move nothing; an in-place index update (the KV cache's write of one
    token) moves its update region twice (read and write), as the
    reference counts ``dynamic-update-slice``. Eager PyTorch makes every op
    its own kernel boundary, so this bounds HBM traffic from above, as the
    reference's count does under the CPU backend's coarser fusion.
  * ``collective_bytes`` by kind (the reference's names), each call's wire
    bytes derated for a ring by :func:`ring_wire_bytes`, the reference's
    rule.

Everything is per rank: the record is one rank's program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

import torch

from repro_torch.launch.flops import FlopCounter

aten = torch.ops.aten

# Bytes an element of each dtype, by the HLO names the reference's table
# uses (copied from its ``_DTYPE_BYTES``), and the torch dtypes' names.
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2,
                "s64": 8, "s32": 4, "s16": 2, "s8": 1,
                "u64": 8, "u32": 4, "u16": 2, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1}
_HLO_NAME = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
             torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
             torch.bool: "pred", torch.complex64: "c64",
             torch.complex128: "c128", torch.float8_e4m3fn: "f8e4m3fn",
             torch.float8_e5m2: "f8e5m2"}

# c10d ops -> the reference's collective kinds.
_COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
                "allgather_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_": "reduce-scatter",
                "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
                "send": "collective-permute"}
_INPLACE_UPDATES = {aten.index_copy_, aten.index_put_, aten.scatter_,
                    aten.index_add_, aten.masked_scatter_}
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.lift_fresh, aten.lift_fresh_copy, aten._local_scalar_dense}


@dataclass
class HloCost:
    flops: float
    traffic_bytes: float
    collective_bytes: Dict[str, float]

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def ring_wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Wire bytes a rank sends for one collective on a ring of ``group``
    ranks, from the bytes of its output buffer (the reference's rule):
    all-gather and all-to-all move (g-1)/g of their output, reduce-scatter
    (g-1)/g of the g-times-larger input it scatters, all-reduce twice
    (g-1)/g of its buffer, a permute its whole payload."""
    derate = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * derate
    if kind == "collective-permute":
        return float(out_bytes)
    if kind == "reduce-scatter":
        return out_bytes * group * derate
    return out_bytes * derate


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(_HLO_NAME.get(t.dtype, "f32"), 4)


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return ProcessGroup.unbox(a).size()
    return 1


class OpRecorder(FlopCounter):
    """Records ``[name, product_flops, traffic_bytes]`` an op (a collective
    adds ``kind, out_bytes, group``) in ``ops``, and the peak of the bytes
    of live storages in ``peak_bytes`` (:meth:`hold` seeds the arguments).
    A storage counts from the op that makes it until a sweep, every
    :data:`SWEEP` ops, finds it freed (autograd's saved tensors keep theirs
    alive): the peak is an upper bound by at most what a sweep's ops free."""

    SWEEP = 32

    def __init__(self):
        super().__init__()
        self.ops: List[list] = []
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def hold(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        st = t.untyped_storage()
        key = st._cdata
        old = self._live.get(key)
        if old is not None and not old[0].expired():
            return
        if old is not None:                   # the address was reused
            self.live_bytes -= old[1]
        self._live[key] = (StorageWeakRef(st), st.nbytes())
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "prim":          # metadata queries (.device)
            return func(*args, **(kwargs or {}))
        before = self.matmul
        out = super().__torch_dispatch__(func, types, args, kwargs)
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _info_of(func)
        name, traffic_rule, kind = info
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        if len(self.ops) % self.SWEEP == 0:
            self._sweep()
        for t in outs:
            self._track(t)
        if traffic_rule == "c10d":
            if kind is None:
                self.ops.append([name, 0.0, 0.0])
                return out
            ins = _tensors(args)
            if kind in ("all-reduce", "collective-permute"):
                payload = sum(tensor_bytes(t) for t in ins)
            else:
                payload = tensor_bytes(ins[0])       # the output buffer
            traffic = sum(tensor_bytes(t) for t in ins)
            self.ops.append([name, 0.0, float(traffic), kind, float(payload),
                             _group_size(args)])
            return out
        if traffic_rule == "none":
            traffic = 0.0
        elif traffic_rule == "update":
            traffic = 2.0 * tensor_bytes(_tensors(args)[-1])
        else:
            traffic = float(sum(tensor_bytes(t) for t in _tensors(args))
                            + sum(tensor_bytes(t) for t in outs))
        self.ops.append([name, self.matmul - before, traffic])
        return out


_INFO: dict = {}           # op overload -> (name, traffic rule, collective)


def _info_of(func):
    name = func.overloadpacket.__name__
    if func.namespace == "c10d":
        return f"c10d.{name}", "c10d", _COLLECTIVES.get(name)
    packet = func.overloadpacket
    if func.is_view or packet in _NO_TRAFFIC:
        return name, "none", None
    if packet in _INPLACE_UPDATES:
        return name, "update", None
    return name, "all", None


def cost_from_ops(ops: Sequence[list]) -> HloCost:
    """The :class:`HloCost` of one rank's op record (the module
    docstring)."""
    flops = traffic = 0.0
    coll: Dict[str, float] = {}
    for op in ops:
        flops += op[1]
        traffic += op[2]
        if len(op) > 3:
            kind, payload, group = op[3], op[4], op[5]
            coll[kind] = coll.get(kind, 0.0) + ring_wire_bytes(kind, payload,
                                                               group)
    return HloCost(flops=flops, traffic_bytes=traffic, collective_bytes=coll)


__all__ = ["HloCost", "OpRecorder", "cost_from_ops", "ring_wire_bytes",
           "tensor_bytes"]
