"""Model-zoo substrate: param tables, sharding rules, attention, conv/norm.

The port's copy of the JAX package's ``models/common.py``. Single source of
truth per model is a *param table*: a pytree of ``ParamSpec(shape, axes,
dtype)`` where ``axes`` names each dimension with a logical axis
("embed", "heads", "mlp", "experts", "vocab", ...). From the table we
derive (a) initialized parameters, (b) per-leaf mesh-axis tuples via a
logical->mesh rule set, and (c) allocation-free ``meta`` tensors for
dry runs. One structure, three views.

Layouts are the reference's: activations NHWC, conv weights HWIO
(``(kh, kw, Cin/groups, Cout)``), so a parameter tree and a checkpoint
carry across unchanged (:func:`from_reference`). :func:`conv2d` permutes
to PyTorch's NCHW/OIHW views inside the call: the NHWC activation's view
is channels-last (no copy); the weight's OIHW view is not, so the
convolution copies it once a call. ``"SAME"`` padding is XLA's: ``total //
2`` before and the rest after, which differs from PyTorch's symmetric
``padding=`` under a stride of 2.

Entry points that make tensors (:func:`init_params`,
:func:`from_reference`, :func:`posemb_sincos_2d`) default to CUDA and
raise without it; a forward runs where its params live.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pipeline import DeviceLike, resolve_device
from repro_torch.tree import (tree_flatten, tree_flatten_with_path,
                              tree_leaves, tree_map, tree_unflatten)

DTypeLike = Union[str, torch.dtype]


def as_dtype(dt: DTypeLike) -> torch.dtype:
    """A dtype string of the reference's configs (``"float32"``,
    ``"bfloat16"``, ...) or a ``torch.dtype``, as a ``torch.dtype``."""
    if isinstance(dt, torch.dtype):
        return dt
    out = getattr(torch, str(dt), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dt!r}")
    return out


def dtype_name(dt: DTypeLike) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's and JAX's names)."""
    return str(as_dtype(dt)).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim
    dtype: DTypeLike = torch.bfloat16
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 1.0                   # stddev multiplier for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
        object.__setattr__(self, "dtype", as_dtype(self.dtype))


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


# Default logical->mesh rules for the production mesh (DESIGN.md §3).
# "model"-axis tensor parallelism on heads / mlp / experts / vocab;
# everything else replicated; batch dims handled by input shardings.
DEFAULT_RULES: Dict[str, Optional[Any]] = {
    "vocab": "model",
    "vocab_embed": "model",
    "dm_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "mlp": "model",
    "experts": "model",
    "conv_out": None,
    "embed": None,
    "layers": None,
    "head_dim": None,
    None: None,
}


def fanin_scale(spec: ParamSpec) -> float:
    """1/sqrt(fan_in) init, fan_in = product of non-output dims."""
    if len(spec.shape) < 2:
        return 1.0
    fan_in = math.prod(spec.shape[:-1]) / (
        spec.shape[0] if spec.axes and spec.axes[0] == "layers" else 1)
    return 1.0 / math.sqrt(max(fan_in, 1.0))


def init_params(table: Any, generator_or_seed: Union[int, torch.Generator],
                device: DeviceLike = None) -> Any:
    """Initialize a param pytree from a table of ParamSpec, on ``device``
    (``None``: CUDA). A seed makes a generator on that device; a given
    generator draws on its own device, and the draws move. The leaves draw
    in the table's flattening order. The values are not ``jax.random``'s:
    the tests carry the reference's values across with
    :func:`from_reference`."""
    dev = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))
    leaves, treedef = tree_flatten(table, is_leaf=_is_spec)
    out = []
    for spec in leaves:
        if spec.init == "zeros":
            out.append(torch.zeros(spec.shape, dtype=spec.dtype, device=dev))
        elif spec.init == "ones":
            out.append(torch.ones(spec.shape, dtype=spec.dtype, device=dev))
        else:
            std = spec.scale * fanin_scale(spec)
            w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                            device=gen.device)
            out.append((w * std).to(device=dev, dtype=spec.dtype))
    return tree_unflatten(treedef, out)


def param_shapes(table: Any) -> Any:
    """``meta`` tensors of the table's shapes and dtypes (dry-run view, no
    allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"),
                    table, is_leaf=_is_spec)


def param_pspecs(table: Any, rules: Optional[Mapping] = None,
                 mesh: Optional[Mapping[str, int]] = None) -> Any:
    """Per leaf, the tuple of mesh-axis entries (an axis name, a tuple of
    them, or ``None``) that the reference's ``PartitionSpec`` holds, via
    logical->mesh rules.

    When ``mesh`` is given (a dict of axis sizes), a dimension
    whose size is not divisible by the mapped mesh axis size falls back to
    replication (uneven shards are refused) -- e.g. a 1000-class head
    under a 16-way model axis."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh

    def axis_size(entry) -> int:
        if sizes is None or entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(sizes[a] for a in names)

    def one(spec: ParamSpec) -> Tuple:
        parts = []
        for dim, a in zip(spec.shape, spec.axes):
            entry = rules.get(a, None)
            n = axis_size(entry)
            parts.append(entry if (n > 1 and dim % n == 0) or sizes is None
                         else None)
        return tuple(parts)

    return tree_map(one, table, is_leaf=_is_spec)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or of a mapping of sizes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh)


def mesh_coords(mesh) -> Dict[str, int]:
    """Axis name -> this rank's coordinate on a ``DeviceMesh``."""
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_index(entry, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[int, int]:
    """``(index, count)`` of a rank's shard along a dimension whose spec
    entry is ``entry``: row-major over the named axes, as JAX tiles a
    dimension over a tuple of mesh axes."""
    index, count = 0, 1
    for a in _entry_axes(entry):
        index, count = index * sizes[a] + coords[a], count * sizes[a]
    return index, count


def _spec_entries(spec: Tuple, ndim: int) -> Tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shape(shape: Sequence[int], spec: Tuple,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of each rank's shard of a ``shape`` leaf placed by
    ``spec``."""
    out = []
    for dim, entry in zip(shape, _spec_entries(spec, len(shape))):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {entry} "
                             f"({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def local_shard(tensor: torch.Tensor, spec: Tuple, mesh,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The slice of ``tensor`` that ``spec`` (a ``param_pspecs`` tuple)
    places on the rank at ``coords`` of ``mesh`` (a ``DeviceMesh``, whose
    own rank is the default, or a mapping of axis sizes): the counterpart
    of ``jax.device_put(x, NamedSharding(mesh, P(*spec)))`` on that device.
    A view of ``tensor``."""
    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    local_shape(tensor.shape, spec, sizes)              # divisibility
    out = tensor
    for d, entry in enumerate(_spec_entries(spec, tensor.dim())):
        i, n = shard_index(entry, sizes, coords)
        if n > 1:
            size = tensor.shape[d] // n
            out = out.narrow(d, i * size, size)
    return out


def is_spec(x) -> bool:
    """A leaf of a tree of specs: a plain tuple of mesh-axis entries (not
    a named tuple such as ``AdamWState``)."""
    return type(x) is tuple


def map_with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over the leaves of ``tree`` and the matching
    spec tuples of ``specs`` (the same structure, spec tuples as leaves)."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = tree_leaves(specs, is_leaf=is_spec)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves and {len(spec_leaves)} specs")
    return tree_unflatten(treedef, [fn(t, s) for t, s in zip(leaves, spec_leaves)])


def shard_params(params: Any, pspecs: Any, mesh,
                 coords: Optional[Mapping[str, int]] = None) -> Any:
    """Each leaf of ``params`` cut to this rank's piece by its spec
    (:func:`local_shard`), contiguous."""
    return map_with_specs(
        lambda t, s: local_shard(t, s, mesh, coords).contiguous(), params, pspecs)


def unshard_params(params: Any, pspecs: Any, mesh) -> Any:
    """The whole tree from every rank's pieces: each dimension named by a
    spec is all-gathered over its axes' groups of the ``DeviceMesh``, the
    last axis of a tuple first, so a tuple gathers row-major. Collective:
    every rank calls it and gets the whole tree."""
    from repro_torch.models import parallel

    def one(t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        for d, entry in enumerate(_spec_entries(spec, t.dim())):
            t = parallel.all_gather_axes(t, d, _entry_axes(entry), mesh)
        return t.contiguous()
    return map_with_specs(one, params, pspecs)


def param_count(table: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(table,
                                                       is_leaf=_is_spec))


def from_reference(tree: Any, like_table: Any,
                   device: DeviceLike = None) -> Any:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes; bfloat16 as ``ml_dtypes`` or the ``|V2`` that
    ``np.savez`` stores) as the port's tensors on ``device`` (``None``:
    CUDA). The tree, every shape and every dtype must equal
    ``like_table``'s; the values are carried bit for bit."""
    dev = resolve_device(device)
    specs, treedef = tree_flatten(like_table, is_leaf=_is_spec)
    leaves, got_def = tree_flatten_with_path(tree)
    if got_def != treedef:
        raise ValueError(f"tree {got_def} != table {treedef}")
    out = []
    for (path, arr), spec in zip(leaves, specs):
        arr = np.asarray(arr)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {spec.shape}")
        own = np.array(arr, copy=True)         # writable, contiguous
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            name = "bfloat16"
            t = torch.from_numpy(own.view(np.int16)).view(torch.bfloat16)
        else:
            name, t = arr.dtype.name, torch.from_numpy(own)
        if name != dtype_name(spec.dtype):
            raise ValueError(f"{path}: dtype {name} != "
                             f"{dtype_name(spec.dtype)}")
        out.append(t.to(dev))
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast to ``x.dtype``, then ``* scale + bias``
    in that dtype (the reference's order)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding, split-halves formulation.

    x: (..., S, H, D); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, KV-blocked online softmax)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, kv_block: int = 1024
                     ) -> torch.Tensor:
    """Memory-efficient causal attention via online softmax over KV blocks.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0.
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill: 0
    with Sq == Skv; decode: cache length). Never materializes the full
    (Sq, Skv) score matrix: peak is (Sq, kv_block) per head.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = 1.0 / math.sqrt(d)
    q32 = q.float() * scale
    qpos = q_offset + torch.arange(sq, device=q.device)

    if skv <= kv_block:
        # Single-block fast path.
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float())
        mask = qpos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~mask[None, None], -math.inf)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

    n_blocks = math.ceil(skv / kv_block)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        lo = blk * kv_block
        k_blk = k[:, lo:lo + kv_block].float()
        v_blk = v[:, lo:lo + kv_block].float()
        kpos = lo + torch.arange(k_blk.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask[None, None], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> use 0.
        safe = torch.isfinite(m_new)
        m_safe = torch.where(safe, m_new, torch.zeros_like(m_new))
        alpha = torch.where(safe, torch.exp(m - m_safe),
                            torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = alpha * l + p.sum(dim=-1)
        o = alpha[..., None] * o + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q.dtype)


def project_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", h, w)`` as one matmul."""
    d, nh, hd = w.shape
    return (h @ w.reshape(d, nh * hd)).unflatten(-1, (nh, hd))


# Float32 scores of one query chunk of :func:`full_attention`, at most.
ATTN_SCORE_BYTES = 2 << 30


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Non-causal softmax attention in float32, the diffusion models' and
    ViT's.

    q: (B, Sq, H, D); k/v: (B, Sk, H, D) -> (B, Sq, H, D) float32. The
    scores are the float32 product q . k divided by sqrt(D) after it (q is
    not pre-scaled). The queries run in chunks whose (B, H, rows, Sk)
    float32 scores fit ``ATTN_SCORE_BYTES`` (read at call time); each
    chunk's softmax runs over all keys at once, so every row is the
    unchunked computation. Under autograd every chunk's probabilities are
    kept for the backward pass."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh = q.float().transpose(1, 2)                       # (B, H, Sq, D)
    kt = k.float().permute(0, 2, 3, 1)                   # (B, H, D, Sk)
    vh = v.float().transpose(1, 2)                       # (B, H, Sk, D)
    div = math.sqrt(d)
    rows = max(1, ATTN_SCORE_BYTES // (b * h * sk * 4))
    outs = [torch.matmul(torch.softmax(torch.matmul(qh[:, :, i:i + rows], kt)
                                       / div, dim=-1), vh)
            for i in range(0, sq, rows)]
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# Conv / pooling helpers (NHWC)
# ---------------------------------------------------------------------------

Padding = Union[str, Sequence[Tuple[int, int]]]


def _pads(padding: Padding, size: Tuple[int, int], window: Tuple[int, int],
          stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of XLA's ``padding`` for an input of
    spatial ``size``: ``"VALID"`` none; ``"SAME"`` out = ceil(in / stride)
    with ``total // 2`` before and the rest after; or explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}")
        pads = []
        for n, k in zip(size, window):
            out = -(-n // stride)
            total = max((out - 1) * stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def _nchw_padded(x: torch.Tensor, pads, value: float = 0.0):
    """The NCHW (channels-last) view of NHWC ``x``, and the symmetric
    padding left for the op: an asymmetric pair is padded here."""
    xc = x.permute(0, 3, 1, 2)
    (t, b), (l, r) = pads
    if t == b and l == r:
        return xc, (t, l)
    return F.pad(xc, (l, r, t, b), value=value), (0, 0)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: Padding = "SAME", groups: int = 1) -> torch.Tensor:
    """x: (B,H,W,Cin), w: (kh,kw,Cin/groups,Cout) -> (B,H',W',Cout)."""
    pads = _pads(padding, x.shape[1:3], w.shape[:2], stride)
    xc, pad = _nchw_padded(x, pads)
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                 padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: Padding = "SAME") -> torch.Tensor:
    """w: (kh, kw, 1, C) with groups = C."""
    return conv2d(x, w, stride=stride, padding=padding, groups=x.shape[-1])


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: Padding = "VALID") -> torch.Tensor:
    """Window sums in float32 over zero padding, / window**2."""
    pads = _pads(padding, x.shape[1:3], (window, window), stride)
    xc, pad = _nchw_padded(x.float(), pads)
    s = F.avg_pool2d(xc, window, stride, padding=pad,
                     count_include_pad=True)
    return s.permute(0, 2, 3, 1).to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: Padding = "SAME") -> torch.Tensor:
    """Window maxima over ``-inf`` padding."""
    pads = _pads(padding, x.shape[1:3], (window, window), stride)
    xc = x.permute(0, 3, 1, 2)
    (t, b), (l, r) = pads
    if t or b or l or r:
        xc = F.pad(xc, (l, r, t, b), value=-math.inf)
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def batch_stats_group(mesh, batch_axes):
    """The group a data-parallel step's training BatchNorm means its
    statistics over: the batch axes' group of ``mesh``, or None (one
    device, no batch axes, or axes of size 1)."""
    if mesh is None or not batch_axes:
        return None
    sizes = mesh_sizes(mesh)
    if math.prod(sizes[a] for a in batch_axes) == 1:
        return None
    from repro_torch.core.pipeline import batch_group
    return batch_group(mesh, tuple(batch_axes))[0]


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, training: bool,
               eps: float = 1e-5, axis_name=None):
    """BatchNorm. In training mode returns (y, batch_mean, batch_var), the
    variance as E[x^2] - E[x]^2 in float32; in inference mode (y, mean,
    var) from the running stats. ``axis_name``: None, or the process group
    (:func:`batch_stats_group`) whose ranks' equal batch shards the
    training statistics are meaned over, the whole batch's, as GSPMD takes
    the reference's over a batch-sharded array. The reference's named
    sync-BN axis (a string) has no counterpart and raises."""
    if isinstance(axis_name, str):
        raise NotImplementedError("a named sync-BN axis is not ported; pass "
                                  "None or the batch axes' process group")
    x32 = x.float()
    if training:
        red = tuple(range(x.ndim - 1))
        bm = x32.mean(dim=red)
        msq = x32.square().mean(dim=red)
        if axis_name is not None:
            from repro_torch.models import parallel
            bm = parallel.mean_of_shards(bm, axis_name)
            msq = parallel.mean_of_shards(msq, axis_name)
        bv = msq - bm.square()
    else:
        bm, bv = mean.float(), var.float()
    y = (x32 - bm) * torch.rsqrt(bv + eps) * scale.float() + bias
    return y.to(x.dtype), bm, bv


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    b, h, w, c = x.shape
    g = math.gcd(groups, c)      # largest group count dividing c
    x32 = x.float().reshape(b, h, w, g, c // g)
    mu = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = x32.var(dim=(1, 2, 4), keepdim=True, correction=0)
    y = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return y.to(x.dtype) * scale + bias


def bn_table(ch: int, dtype: DTypeLike = torch.float32
             ) -> Dict[str, ParamSpec]:
    """BatchNorm parameter group. ``mean``/``var`` are running stats,
    refreshed functionally by ``bn_apply``; the train step merges the
    returned stats back into the param tree."""
    return {
        "scale": ParamSpec((ch,), ("conv_out",), dtype, init="ones"),
        "bias": ParamSpec((ch,), ("conv_out",), dtype, init="zeros"),
        "mean": ParamSpec((ch,), ("conv_out",), dtype, init="zeros"),
        "var": ParamSpec((ch,), ("conv_out",), dtype, init="ones"),
    }


def bn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, training: bool,
             axis_name=None, momentum: float = 0.9):
    """Returns (y, new_bn_params): new stats only change in training."""
    y, bm, bv = batch_norm(x, p["scale"], p["bias"], p["mean"], p["var"],
                           training, axis_name=axis_name)
    if training:
        new = dict(p)
        new["mean"] = (momentum * p["mean"] + (1 - momentum) * bm.detach()
                       ).to(p["mean"].dtype)
        new["var"] = (momentum * p["var"] + (1 - momentum) * bv.detach()
                      ).to(p["var"].dtype)
        return y, new
    return y, p


def merge_bn_stats(opt_params: Any, stats_params: Any) -> Any:
    """Take optimizer-updated leaves except BN running stats, which come
    from the forward pass (paths ending in mean/var under a bn group)."""
    flat_opt, treedef = tree_flatten_with_path(opt_params)
    flat_new = tree_leaves(stats_params)
    out = []
    for (key, leaf), new_leaf in zip(flat_opt, flat_new):
        if key.endswith("['mean']") or key.endswith("['var']"):
            out.append(new_leaf)
        else:
            out.append(leaf)
    return tree_unflatten(treedef, out)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def posemb_sincos_2d(h: int, w: int, dim: int,
                     device: DeviceLike = None) -> torch.Tensor:
    """(h*w, dim) fixed 2-D sin-cos position embedding on ``device``
    (``None``: CUDA)."""
    device = resolve_device(device)
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing="ij")
    omega = torch.arange(dim // 4, dtype=torch.float32,
                         device=device) / (dim // 4 - 1)
    omega = 1.0 / (10000 ** omega)
    y = y.reshape(-1).float()[:, None] * omega[None]
    x = x.reshape(-1).float()[:, None] * omega[None]
    return torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)],
                     dim=1)


def run_stacked(block, x, stacked: Any, training: bool):
    """``block(layer_params, x) -> (x, new_layer_params)`` over the leading
    ("layers") axis of the stacked params ``stacked``, the reference's
    ``lax.scan``. In training the new params are stacked back; otherwise
    they are the same values, and ``stacked`` itself is returned."""
    news = []
    for i in range(tree_leaves(stacked)[0].shape[0]):
        x, new = block(tree_map(lambda t: t[i], stacked), x)
        news.append(new)
    if not training:
        return x, stacked
    return x, tree_map(lambda *ts: torch.stack(ts), *news)


def take_clipped(table: torch.Tensor, ids) -> torch.Tensor:
    """Rows of ``table`` as the reference's ``table.at[ids].get(
    mode="clip")`` takes them: a negative id counts from the end (``id +
    rows``), then every id is clipped into ``[0, rows)``. The result has
    ``ids``' shape followed by a row's."""
    ids = torch.as_tensor(ids, device=table.device)
    n = table.shape[0]
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n, flat).clamp(0, n - 1)
    return table.index_select(0, flat).reshape(*ids.shape, *table.shape[1:])


def cosine_abar(t: torch.Tensor) -> torch.Tensor:
    """The diffusion models' cosine schedule: alpha-bar at integer step
    ``t`` (B,), as (B, 1, 1, 1) float32."""
    return (torch.cos((t.float() / 1000.0) * torch.pi / 2) ** 2)[:, None, None, None]


def ddim_update(zt: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
                t_next: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step of ``zt`` from ``t`` to ``t_next`` given
    the (guided) noise estimate ``eps``, in float32."""
    abar, abar_n = cosine_abar(t), cosine_abar(t_next)
    z0 = (zt - torch.sqrt(1 - abar) * eps) / torch.sqrt(abar)
    return torch.sqrt(abar_n) * z0 + torch.sqrt(1 - abar_n) * eps


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label] in float32: the zoo's
    classifier loss."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()
