"""Decoder-only transformer LM: GQA, RoPE, MoE, KV cache, the model axis.

The port's copy of the JAX package's ``models/transformer.py``. It covers
the four LM ids (moonshot-v1-16b-a3b, llama4-scout-17b-a16e, granite-20b,
llama3-8b):

  * GQA with any kv-head count (MQA = 1); ``pad_heads_to`` pads the q/kv
    heads as the reference's param table does.
  * MoE FFN with sort-based dispatch into ``(E * cap, dm)`` buffers:
    tokens past an expert's capacity are dropped (they land in a spare
    row that is sliced off) and the combine gathers at the clipped slot
    times ``valid``. Routing takes the top k of the float32 router
    probabilities by a stable descending sort, so ties go to the lower
    expert id, as ``lax.top_k`` breaks them.
  * llama4-style chunked local attention (``chunk_attn``) with a RoPE-less
    global layer every ``global_every`` layers. The layer flags are
    static, so the port branches on the host once a layer where the
    reference uses ``lax.cond``/``jnp.where``.
  * The layers' params stay stacked on a leading axis; the forward loops
    over it (the reference scans it). ``remat`` recomputes in the backward
    pass with ``torch.utils.checkpoint(use_reentrant=False)``:
    ``remat_policy="minimal"`` checkpoints each layer (its input is kept),
    ``"save_sums"`` checkpoints the attention and the FFN sublayer apart,
    so the residual sums between them are kept and the backward pass does
    not recompute the attention to reach the FFN's input. Either gives the
    gradients of ``remat=False``.

The model axis follows the reference's shardings with explicit
collectives (``models/parallel.py``), the port's counterpart of its
``shard_map`` bodies and of what GSPMD derives from ``param_pspecs``.
Each rank holds the pieces of each leaf that :func:`lm_param_specs`
places on it (``common.shard_params``) and its shard of the batch:

  * tensor parallelism: ``wq``/``wk``/``wv`` column-parallel over the
    (padded) heads and kv heads, ``wo`` and the dense ``w_down``
    row-parallel with their partial sums all-reduced in ``reduce_dtype``
    (bfloat16 partials cross ranks as bfloat16), ``w_gate``/``w_up``
    over ``"mlp"``; the embedding over the vocabulary (a masked lookup and
    an all-reduce) or over ``dm`` (an all-gather), as ``embed_shard``
    places it; the unembed vocab-parallel, its logits all-gathered. A leaf
    that ``param_pspecs`` leaves whole (its dimension does not divide the
    axis) is computed whole on every rank with no collective.
  * ``seq_shard``: between layers the residual stream is sequence-sharded
    over ``"model"``; it is all-gathered before the attention and FFN
    inputs and reduce-scattered after the row-parallel products (the
    reference's ``_seq_constraint``), where the sequence divides the axis.
  * The MoE: where the sequence divides ``"model"`` the tokens are
    sequence-sharded and sent to the ``E / n`` experts of each rank by one
    all-to-all each way, the capacity taken from the rank's token count;
    else (decode) each rank runs its experts on all tokens and the outputs
    are all-reduced. ``aux`` is meaned over ``"model"`` and the batch axes.
  * ``decode_seq_shard``: distributed flash-decoding over a KV cache
    sequence-sharded on ``"model"``, the heads whole.

On a mesh whose ``"model"`` axis is 1 (or ``mesh=None``) the path is the
one-device one: the same ops and no collective over it. ``reduce_dtype``
names the dtype of the ``wo``/``w_down`` partial sums: on one card a
bfloat16 product is cuBLAS's float32 accumulation rounded once to
bfloat16, either way.

Serving: :func:`make_prefill` returns the last position's logits and a
KV cache padded to ``max_len``; :func:`make_decode_step` writes each new
token's K/V into that cache in place (a copy of the whole cache a token
would dominate decode at long contexts) and keeps ``pos`` an int32 0-d
tensor on the device. The write's start, the chunked layers' window and
the attention's offset are computed on the device from ``pos``, so a
decode step reads nothing back to the host. Both run under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pipeline import DeviceLike, batch_group, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import parallel as par
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 32
    d_ff: int = 256
    vocab: int = 512
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # MoE (0 experts = dense FFN).
    moe_experts: int = 0
    moe_topk: int = 1
    moe_capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # llama4-style local attention: 0 = full attention everywhere.
    chunk_attn: int = 0
    global_every: int = 4            # every Nth layer is global (RoPE-less)
    # TP head padding (set to the mesh model-axis size by the launcher).
    pad_heads_to: int = 1
    dtype: str = "bfloat16"
    kv_block: int = 1024
    remat: bool = True               # activation checkpointing per layer
    # Perf levers of the reference's multi-device paths (the module
    # docstring); on one device only remat_policy acts.
    seq_shard: bool = False          # shard residual stream seq over "model"
    remat_policy: str = "minimal"    # minimal | save_sums
    reduce_dtype: str = "float32"    # dtype of the wo / w_down partial sums
    embed_shard: str = "vocab"       # vocab | dm: embedding-table sharding
    microbatch: int = 1              # gradient-accumulation factor
    decode_seq_shard: bool = False   # long-context decode: KV cache sequence
    #                                  sharded over "model"

    @property
    def n_heads_padded(self) -> int:
        return -(-self.n_heads // self.pad_heads_to) * self.pad_heads_to

    @property
    def n_kv_padded(self) -> int:
        return -(-self.n_kv_heads // self.pad_heads_to) * self.pad_heads_to

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)

    def param_count(self, padded: bool = False) -> int:
        return cm.param_count(lm_param_table(self)) if padded else \
            _logical_param_count(self)

    def active_param_count(self) -> int:
        """Per-token active params (MoE counts top-k experts only)."""
        c = self
        attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
        ffn = 3 * c.d_model * c.d_ff
        ffn_active = ffn * (c.moe_topk if c.moe_experts else 1)
        router = c.d_model * c.moe_experts if c.moe_experts else 0
        per_layer = attn + ffn_active + router + 2 * c.d_model
        return (c.n_layers * per_layer + 2 * c.vocab * c.d_model
                + c.d_model)


def _logical_param_count(c: LMConfig) -> int:
    attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
    ffn = 3 * c.d_model * c.d_ff * (c.moe_experts if c.moe_experts else 1)
    router = c.d_model * c.moe_experts if c.moe_experts else 0
    per_layer = attn + ffn + router + 2 * c.d_model
    return c.n_layers * per_layer + 2 * c.vocab * c.d_model + c.d_model


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def lm_param_table(c: LMConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    L, dm, hd = c.n_layers, c.d_model, c.head_dim
    hp, kp = c.n_heads_padded, c.n_kv_padded
    layer: Dict[str, Any] = {
        "attn_norm": ParamSpec((L, dm), ("layers", "embed"), dt, init="ones"),
        "wq": ParamSpec((L, dm, hp, hd), ("layers", "embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((L, dm, kp, hd), ("layers", "embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((L, dm, kp, hd), ("layers", "embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((L, hp, hd, dm), ("layers", "heads", "head_dim", "embed"), dt),
        "mlp_norm": ParamSpec((L, dm), ("layers", "embed"), dt, init="ones"),
    }
    if c.moe_experts:
        E, dff = c.moe_experts, c.d_ff
        layer.update({
            "router": ParamSpec((L, dm, E), ("layers", "embed", None),
                                torch.float32),
            "w_gate": ParamSpec((L, E, dm, dff), ("layers", "experts", "embed", None), dt),
            "w_up": ParamSpec((L, E, dm, dff), ("layers", "experts", "embed", None), dt),
            "w_down": ParamSpec((L, E, dff, dm), ("layers", "experts", None, "embed"), dt),
        })
    else:
        dff = c.d_ff
        layer.update({
            "w_gate": ParamSpec((L, dm, dff), ("layers", "embed", "mlp"), dt),
            "w_up": ParamSpec((L, dm, dff), ("layers", "embed", "mlp"), dt),
            "w_down": ParamSpec((L, dff, dm), ("layers", "mlp", "embed"), dt),
        })
    return {
        # Dedicated logical axes: the input-embedding sharding is a perf
        # lever (cfg.embed_shard) independent of the unembed projection.
        "embed": ParamSpec((c.vocab, dm), ("vocab_embed", "dm_embed"), dt),
        "layers": layer,
        "final_norm": ParamSpec((dm,), ("embed",), dt, init="ones"),
        "unembed": ParamSpec((dm, c.vocab), ("embed", "vocab"), dt),
    }


def lm_rules(c: LMConfig) -> Dict[str, Any]:
    """Logical->mesh rule overrides implied by the config's perf levers."""
    if c.embed_shard == "dm":
        return {"vocab_embed": None, "dm_embed": "model"}
    return {"vocab_embed": "model", "dm_embed": None}


# ---------------------------------------------------------------------------
# Placement: what a rank holds and which collectives its sublayers run
# ---------------------------------------------------------------------------

def lm_param_specs(cfg: LMConfig, mesh, serving: bool = False) -> Dict[str, Any]:
    """Per leaf the mesh-axis tuple that places it: ``common.param_pspecs``
    under :func:`lm_rules` on ``mesh`` (a ``DeviceMesh`` or a mapping of
    axis sizes). For serving under ``decode_seq_shard`` the heads stay
    whole (``heads=None, kv_heads=None``), as the reference's decode cells
    place them."""
    rules = dict(lm_rules(cfg))
    if serving and cfg.decode_seq_shard:
        rules.update(heads=None, kv_heads=None)
    return cm.param_pspecs(lm_param_table(cfg), rules, cm.mesh_sizes(mesh))


class _Rank:
    """One rank's view of the mesh: the model axis's size, index and group,
    the batch axes' group, and, read from each leaf's spec, which
    sublayers run tensor-parallel (a leaf that ``param_pspecs`` leaves
    whole, its dimension not dividing the axis, is computed whole on every
    rank). ``mesh=None``, or a model axis of 1: every flag off, no
    collective over "model"."""

    def __init__(self, cfg: LMConfig, mesh=None, batch_axes=None,
                 serving: bool = False):
        self.cfg = cfg
        sizes = {} if mesh is None else cm.mesh_sizes(mesh)
        if math.prod(sizes.values()) > 1 and not hasattr(mesh, "get_group"):
            raise ValueError(f"a mesh of {sizes} devices needs a DeviceMesh "
                             "(its groups), not a mapping of sizes")
        self.n = sizes.get("model", 1)
        self.model = mesh.get_group("model") if self.n > 1 else None
        self.index = mesh.get_local_rank("model") if self.n > 1 else 0
        self.batch_axes = tuple(batch_axes) if (mesh is not None
                                                and batch_axes) else None
        self.batch = None
        if self.batch_axes and math.prod(sizes[a] for a in self.batch_axes) > 1:
            self.batch = batch_group(mesh, self.batch_axes)[0]
        self.heads = self.kv_heads = self.mlp = self.unembed = False
        self.embed: Optional[str] = None
        if self.n == 1:
            return
        sp = lm_param_specs(cfg, mesh, serving)
        lay = sp["layers"]
        self.heads = lay["wq"][2] == "model"
        self.kv_heads = lay["wk"][2] == "model"
        self.embed = ("vocab" if sp["embed"][0] == "model" else
                      "dm" if sp["embed"][1] == "model" else None)
        self.unembed = sp["unembed"][1] == "model"
        if cfg.moe_experts:
            if lay["w_gate"][1] != "model":
                raise ValueError(f"{cfg.moe_experts} experts do not split over "
                                 f"a model axis of {self.n}")
        else:
            self.mlp = lay["w_gate"][2] == "model"

    def seq_sharded(self, s: int) -> bool:
        """The residual stream is sequence-sharded over "model" between
        layers (the reference's ``_seq_constraint``)."""
        return bool(self.cfg.seq_shard and self.n > 1 and self.batch_axes
                    and s % self.n == 0 and s >= self.n)

    def param(self, w: torch.Tensor, partial: bool) -> torch.Tensor:
        """A replicated leaf used where this rank computes only a part:
        its gradient is summed over "model" (``parallel.enter``)."""
        return par.enter(w, self.model) if (partial and self.n > 1) else w

    def enter(self, h: torch.Tensor, tp: bool, sp: bool) -> torch.Tensor:
        """A sublayer's input: all-gathered over the sequence under ``sp``;
        into a tensor-parallel sublayer (``tp``) with a summing backward."""
        if self.n == 1:
            return h
        if tp:
            return par.gather_in(h, 1, self.model) if sp else \
                par.enter(h, self.model)
        return par.gather_out(h, 1, self.model) if sp else h

    def leave(self, y: torch.Tensor, tp: bool, sp: bool,
              dtype: torch.dtype) -> torch.Tensor:
        """A sublayer's output (the row-parallel product under ``tp``): its
        partial sums cross ranks in ``reduce_dtype``, reduce-scattered over
        the sequence under ``sp``, else all-reduced."""
        y = y.to(_accum_dtype(self.cfg))
        if self.n > 1 and tp:
            y = par.scatter_out(y, 1, self.model) if sp else \
                par.reduce(y, self.model)
        elif self.n > 1 and sp:
            y = par.split(y, 1, self.model)
        return y.to(dtype)


# ---------------------------------------------------------------------------
# MoE FFN (sort-based dispatch; expert-parallel over "model")
# ---------------------------------------------------------------------------

def _route(x, router, cfg: LMConfig):
    """Top-k routing. Returns (top_w, top_e, probs)."""
    logits = x.float() @ router.float()                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[:, :cfg.moe_topk], idx[:, :cfg.moe_topk]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e, probs


def _aux_loss(top_e, probs, E: int) -> torch.Tensor:
    # one-hot by comparison: F.one_hot checks its ids on the host
    one_hot = top_e[:, :1] == torch.arange(E, device=top_e.device)
    frac_tokens = one_hot.float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return E * (frac_tokens * frac_probs).sum()


def _expert_ffn(xs, w_gate, w_up, w_down, dtype):
    g = torch.einsum("ecd,edf->ecf", xs, w_gate)
    u = torch.einsum("ecd,edf->ecf", xs, w_up)
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _dispatch(flat_e, t: int, k: int, n_e: int, cap: int, dev):
    """Sort the (token, choice) pairs by expert (stable: ties keep token
    order) and give each a slot ``e * cap + place`` among its expert's,
    ``n_e * cap`` where it is past the capacity or ``flat_e == n_e`` (not
    this rank's). Returns (order, sorted token ids, slots in sorted order)."""
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_e + 1, device=dev),
                                side="left")
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = (pos < cap) & (sorted_e < n_e)
    slot = torch.where(keep, sorted_e * cap + pos, torch.full_like(pos, n_e * cap))
    return order, flat_t[order], slot


def _combine(o, order, slot_sorted, top_w, n_slots: int, t: int, k: int, dm: int):
    """Unsort the slots back to (T, k), gather the expert outputs, weight
    them (0 for a dropped pair) and sum each token's k."""
    slot_flat = torch.empty_like(slot_sorted).index_copy_(0, order, slot_sorted)
    picked = o.index_select(0, slot_flat.clamp(0, n_slots - 1))  # (T*k, dm)
    valid = (slot_flat < n_slots).to(o.dtype)
    w = (top_w.reshape(-1).to(o.dtype) * valid)[:, None]
    return (picked * w).reshape(t, k, dm).sum(dim=1)


def _moe_local(x, router, w_gate, w_up, w_down, *, cfg: LMConfig,
               group=None, n_model: int = 1):
    """MoE body of a rank that holds distinct tokens (sequence-sharded over
    "model" when ``n_model > 1``). x: (T_loc, dm); w_*: this rank's
    ``E / n_model`` experts. The capacity comes from the local token count,
    as the reference's; the (E * cap, dm) buffer goes out in ``n_model``
    equal chunks by one all-to-all and the expert outputs come back by
    another. Returns (y: (T_loc, dm), aux scalar)."""
    E, k = cfg.moe_experts, cfg.moe_topk
    t, dm = x.shape
    e_loc = E // n_model
    cap = max(1, math.ceil(t * k / E * cfg.moe_capacity_factor))

    top_w, top_e, probs = _route(x, router, cfg)
    order, sorted_t, slot = _dispatch(top_e.reshape(-1), t, k, E, cap, x.device)

    # Dispatch: (E*cap, dm) buffers; dropped tokens go to a spare row.
    buf = x.new_zeros((E * cap + 1, dm)).index_copy(
        0, slot, x.index_select(0, sorted_t))[:E * cap]
    if n_model > 1:
        buf = par.all_to_all(buf, group)                     # by source rank
        xs = buf.reshape(n_model, e_loc, cap, dm).transpose(0, 1) \
            .reshape(e_loc, n_model * cap, dm)
    else:
        xs = buf.reshape(E, cap, dm)
    o = _expert_ffn(xs, w_gate, w_up, w_down, x.dtype)
    if n_model > 1:
        o = o.reshape(e_loc, n_model, cap, dm).transpose(0, 1) \
            .reshape(E * cap, dm)
        o = par.all_to_all(o, group)
    o = o.reshape(E * cap, dm)
    y = _combine(o, order, slot, top_w, E * cap, t, k, dm)
    return y, _aux_loss(top_e, probs, E)


def _moe_local_replicated(x, router, w_gate, w_up, w_down, *, cfg: LMConfig,
                          index: int, n_model: int):
    """MoE body when the tokens are the same on every rank of "model"
    (decode: a sequence of 1 does not shard): this rank computes only its
    local experts' contributions for all tokens, the caller sums them over
    "model". No all-to-all and no expert FLOPs twice."""
    E, k = cfg.moe_experts, cfg.moe_topk
    t, dm = x.shape
    e_loc = E // n_model
    cap = max(1, math.ceil(t * k / E * cfg.moe_capacity_factor))

    top_w, top_e, probs = _route(x, router, cfg)
    local_e = top_e - index * e_loc                               # (T, k)
    is_local = (local_e >= 0) & (local_e < e_loc)
    flat_e = torch.where(is_local, local_e, torch.full_like(local_e, e_loc))
    order, sorted_t, slot = _dispatch(flat_e.reshape(-1), t, k, e_loc, cap,
                                      x.device)
    buf = x.new_zeros((e_loc * cap + 1, dm)).index_copy(
        0, slot, x.index_select(0, sorted_t))[:e_loc * cap]
    o = _expert_ffn(buf.reshape(e_loc, cap, dm), w_gate, w_up, w_down,
                    x.dtype).reshape(e_loc * cap, dm)
    y = _combine(o, order, slot, top_w, e_loc * cap, t, k, dm)
    return y, _aux_loss(top_e, probs, E)


def _moe(h, lp, cfg: LMConfig, rank: _Rank, sp: bool):
    """The MoE sublayer on the normed ``h`` (B, S or S/n under ``sp``, dm):
    ``(y, aux)``. Where the sequence divides "model" the tokens are
    sequence-sharded and dispatched by all-to-all (``_moe_local``), else
    every rank runs its experts on all tokens and the outputs are summed
    (``_moe_local_replicated``). ``aux`` is meaned over "model" (sharded
    tokens) and over the batch axes, as ``make_moe_ffn``'s."""
    b, s, dm = h.shape
    n = rank.n
    w = (lp["w_gate"], lp["w_up"], lp["w_down"])
    if n == 1:
        y, aux = _moe_local(h.reshape(b * s, dm), lp["router"], *w, cfg=cfg)
        y = y.reshape(b, s, dm)
    elif sp or s % n == 0:
        hl = h if sp else par.split(h, 1, rank.model)
        y, aux = _moe_local(hl.reshape(-1, dm), rank.param(lp["router"], True),
                            *w, cfg=cfg, group=rank.model, n_model=n)
        y = y.reshape(hl.shape)
        aux = par.mean_model(aux, rank.model)
        if not sp:
            y = par.gather_out(y, 1, rank.model)
    else:
        y, aux = _moe_local_replicated(
            par.enter(h, rank.model).reshape(b * s, dm),
            rank.param(lp["router"], True), *w, cfg=cfg, index=rank.index,
            n_model=n)
        y = par.reduce(y, rank.model).reshape(b, s, dm)
        # aux is the same on every rank: 1/n of its gradient from each,
        # as the partial gradients of the rest of the body.
        aux = par.scale_grad(aux, 1.0 / n)
    return y, par.mean_batch(aux, rank.batch)


def make_moe_ffn(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",),
                 seq_len: Optional[int] = None):
    """Returns moe_ffn(x (B,S,dm), router, w_gate, w_up, w_down) -> (y,
    aux_loss): this rank's batch shard ``x`` (the same on every rank of
    "model"), the replicated router and this rank's experts. ``seq_len``
    is read from ``x``; the argument is the reference's."""
    del seq_len
    rank = _Rank(cfg, mesh, batch_axes)

    def moe_ffn(x, router, w_gate, w_up, w_down):
        return _moe(x, {"router": router, "w_gate": w_gate, "w_up": w_up,
                        "w_down": w_down}, cfg, rank, False)

    return moe_ffn


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------

def _kv_for_heads(k: torch.Tensor, cfg: LMConfig, rank: _Rank) -> torch.Tensor:
    """The kv heads this rank's query heads read, where the kv projection
    is whole on every rank but the query heads are split (``n_kv_padded``
    does not divide "model")."""
    if not (rank.heads and not rank.kv_heads):
        return k
    hp, kp = cfg.n_heads_padded, cfg.n_kv_padded
    hq, rep = hp // rank.n, hp // kp
    k0 = rank.index * hq // rep
    k1 = ((rank.index + 1) * hq - 1) // rep + 1
    if hq % (k1 - k0):
        raise ValueError(f"{hq} query heads a rank do not map evenly onto "
                         f"kv heads {k0}-{k1 - 1}")
    return k[:, :, k0:k1]


def _attention(x, lp, positions, cfg: LMConfig, is_global: bool, rank: _Rank,
               kv_cache=None, cache_pos=None, sp: bool = False,
               seqpar: bool = False):
    """One attention sublayer on this rank. Returns (out, (k_new, v_new)).

    Training/prefill: kv_cache None, positions (B, S); under ``sp`` x holds
    this rank's S/n positions and is all-gathered after the norm.
    Decode: kv_cache (k, v) each (B, S_max, Kp_local, hd), written in place
    at ``clip(cache_pos, 0, S_max - S)`` (``dynamic_update_slice``'s
    clamp); cache_pos an int32 0-d tensor; under ``seqpar`` the cache is
    this rank's slice of the sequence and the attention is
    :func:`_seqpar_attend`'s. Query heads (and kv heads, where they
    divide) are this rank's; the ``wo`` product's partial sums are reduced
    over "model" (``_Rank.leave``).
    """
    h = cm.rms_norm(x, rank.param(lp["attn_norm"], sp), cfg.norm_eps)
    h = rank.enter(h, rank.heads, sp)
    b, s = h.shape[:2]
    kv_part = rank.heads and not rank.kv_heads
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, rank.param(lp["wk"], kv_part))
    v = torch.einsum("bsd,dhk->bshk", h, rank.param(lp["wv"], kv_part))

    # Plain causal archs: RoPE everywhere; llama4-style: chunked layers
    # use RoPE, global layers are NoPE.
    if cfg.chunk_attn == 0 or not is_global:
        q = cm.rope(q, positions, cfg.rope_theta)
        k = cm.rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        ka, va = _kv_for_heads(k, cfg, rank), _kv_for_heads(v, cfg, rank)
        if cfg.chunk_attn and s > cfg.chunk_attn and not is_global:
            w = cfg.chunk_attn
            n = s // w
            o = cm.causal_attention(q.reshape(b * n, w, *q.shape[2:]),
                                    ka.reshape(b * n, w, *ka.shape[2:]),
                                    va.reshape(b * n, w, *va.shape[2:]),
                                    kv_block=cfg.kv_block)
            o = o.reshape(b, s, *o.shape[2:])
        else:
            o = cm.causal_attention(q, ka, va, kv_block=cfg.kv_block)
        k_out, v_out = k, v
    elif seqpar:
        k_out, v_out = kv_cache
        o = _seqpar_attend(q, k, v, k_out, v_out, cache_pos, is_global, cfg,
                           rank)
    else:
        ck, cv = kv_cache
        s_max = ck.shape[1]
        ar = torch.arange(s, device=x.device)
        at = torch.clamp(cache_pos, 0, s_max - s).long() + ar
        k_out = ck.index_copy_(1, at, k)
        v_out = cv.index_copy_(1, at, v)
        ka, va = _kv_for_heads(k_out, cfg, rank), _kv_for_heads(v_out, cfg, rank)
        if cfg.chunk_attn and cfg.chunk_attn < s_max and not is_global:
            w = cfg.chunk_attn
            start = torch.clamp(cache_pos + s - w, 0, s_max - w).long()
            win = start + torch.arange(w, device=x.device)
            o = cm.causal_attention(q, ka.index_select(1, win),
                                    va.index_select(1, win),
                                    q_offset=cache_pos - start,
                                    kv_block=cfg.kv_block)
        else:
            o = cm.causal_attention(q, ka, va, q_offset=cache_pos,
                                    kv_block=cfg.kv_block)
    out = torch.einsum("bshk,hkd->bsd", o, lp["wo"])
    return rank.leave(out, rank.heads, sp, x.dtype), (k_out, v_out)


def _seqpar_attend(q, k_new, v_new, ck, cv, pos, is_global: bool,
                   cfg: LMConfig, rank: _Rank):
    """Distributed flash-decoding (the reference's
    ``make_seqpar_attention``): the KV cache is sequence-sharded over
    "model", ``ck``/``cv`` (B, S_max/n, Kp, hd) this rank's slice. The
    owning rank writes the new token in place; each rank takes a partial
    online softmax over its slice (the chunked layers' window masked in);
    the partials combine with one all-reduce MAX and two all-reduce SUMs of
    (B, H, 1)-sized tensors. ``pos`` stays on the device. Returns (B, 1, H,
    hd)."""
    b, _, h, d = q.shape
    s_loc = ck.shape[1]
    start = rank.index * s_loc
    owned = (pos >= start) & (pos < start + s_loc)
    li = torch.clamp(pos - start, 0, s_loc - 1).long().reshape(1)
    for c, new in ((ck, k_new), (cv, v_new)):
        c.index_copy_(1, li, torch.where(owned, new.to(c.dtype),
                                         c.index_select(1, li)))
    kk = cm._repeat_kv(ck, h // ck.shape[2])
    vv = cm._repeat_kv(cv, h // cv.shape[2])
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk.float())
    abs_pos = start + torch.arange(s_loc, device=q.device)
    mask = abs_pos <= pos
    if cfg.chunk_attn and not is_global:
        mask = mask & (abs_pos > pos - cfg.chunk_attn)
    sc = sc.masked_fill(~mask, -math.inf)
    m = par.all_reduce_(sc.amax(dim=-1).contiguous(), rank.model,
                        dist.ReduceOp.MAX)                     # (B, H, 1)
    safe = torch.isfinite(m)
    p = torch.exp(sc - torch.where(safe, m, torch.zeros_like(m))[..., None])
    p = torch.where(torch.isfinite(sc), p, torch.zeros_like(p))
    l = par.all_reduce_(p.sum(dim=-1), rank.model)
    o = par.all_reduce_(torch.einsum("bhqk,bkhd->bhqd", p, vv.float()),
                        rank.model)
    return (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2).to(q.dtype)


def _accum_dtype(cfg: LMConfig) -> torch.dtype:
    """Dtype of the row-parallel (wo / w_down) products' partial sums: the
    dtype they cross ranks in (bfloat16 halves the all-reduce's bytes)."""
    return torch.bfloat16 if cfg.reduce_dtype == "bfloat16" else torch.float32


def _dense_ffn(x, lp, cfg: LMConfig, rank: _Rank, sp: bool):
    h = cm.rms_norm(x, rank.param(lp["mlp_norm"], sp), cfg.norm_eps)
    h = rank.enter(h, rank.mlp, sp)
    g = torch.einsum("bsd,df->bsf", h, lp["w_gate"])
    u = torch.einsum("bsd,df->bsf", h, lp["w_up"])
    act = F.silu(g.float()).to(x.dtype) * u
    return rank.leave(torch.einsum("bsf,fd->bsd", act, lp["w_down"]),
                      rank.mlp, sp, x.dtype)


def _ffn(x, lp, cfg: LMConfig, rank: _Rank, sp: bool):
    """The FFN sublayer's output and its aux loss (0 for a dense FFN)."""
    if cfg.moe_experts:
        h = cm.rms_norm(x, rank.param(lp["mlp_norm"], sp), cfg.norm_eps)
        return _moe(h, lp, cfg, rank, sp)
    return _dense_ffn(x, lp, cfg, rank, sp), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _layer_flags(cfg: LMConfig) -> Tuple[bool, ...]:
    """Per layer, True where it uses global (full, RoPE-less) attention."""
    if cfg.chunk_attn == 0:
        return (True,) * cfg.n_layers        # all global (plain causal)
    return tuple((i + 1) % cfg.global_every == 0 for i in range(cfg.n_layers))


def _layer_params(layers: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in layers.items()}


def _embed(params, tokens, cfg: LMConfig, rank: Optional[_Rank] = None
           ) -> torch.Tensor:
    """Token ids looked up as the reference's ``embed.at[tokens].get(
    mode="clip")`` does (``common.take_clipped``: a negative id counts from
    the end of the whole vocabulary, then every id is clipped into it),
    cast to the config's dtype. A vocab-sharded table: each rank looks up
    the ids in its rows, zeros the rest and the rows are summed over
    "model" (exact: one rank holds each id); a dm-sharded table: each rank
    looks up its columns and they are all-gathered."""
    table = params["embed"]
    if rank is None or rank.embed is None:
        return cm.take_clipped(table, tokens).to(cfg.torch_dtype)
    if rank.embed == "dm":
        rows = cm.take_clipped(table, tokens)
        return par.gather_out(rows, -1, rank.model).to(cfg.torch_dtype)
    ids = torch.as_tensor(tokens, device=table.device).long()
    ids = torch.where(ids < 0, ids + cfg.vocab, ids).clamp(0, cfg.vocab - 1)
    v_loc = table.shape[0]
    local = ids - rank.index * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = table.index_select(0, local.clamp(0, v_loc - 1).reshape(-1))
    rows = rows.reshape(*ids.shape, -1).masked_fill(~inside[..., None], 0)
    return par.reduce(rows, rank.model).to(cfg.torch_dtype)


def _unembed(x, params, cfg: LMConfig, rank: _Rank, sp: bool) -> torch.Tensor:
    """The final norm and the vocab-parallel unembed, the logits gathered
    over "model": (B, S, V)."""
    x = cm.rms_norm(x, rank.param(params["final_norm"], sp), cfg.norm_eps)
    x = rank.enter(x, rank.unembed, sp)
    logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    if rank.unembed:
        logits = par.gather_out(logits, -1, rank.model)
    return logits


def make_forward(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """Returns forward(params, tokens (B,S)) -> (logits, aux_loss): on a
    mesh, this rank's param shards (``common.shard_params`` by
    :func:`lm_param_specs`) and its batch shard; the logits are this
    batch shard's, whole over the vocabulary, the aux loss meaned over the
    batch axes."""
    rank = _Rank(cfg, mesh, batch_axes)
    flags = _layer_flags(cfg)

    def attn_sub(x, lp, positions, is_global, sp):
        return _attention(x, lp, positions, cfg, is_global, rank, sp=sp)[0]

    def ffn_sub(x, lp, sp):
        return _ffn(x, lp, cfg, rank, sp)

    def layer(x, lp, positions, is_global, sp):
        x = x + attn_sub(x, lp, positions, is_global, sp)
        y, aux = ffn_sub(x, lp, sp)
        return x + y, aux

    def run_layer(x, lp, positions, is_global, sp):
        if not (cfg.remat and torch.is_grad_enabled()):
            return layer(x, lp, positions, is_global, sp)
        if cfg.remat_policy == "save_sums":
            x = x + checkpoint(attn_sub, x, lp, positions, is_global, sp,
                               use_reentrant=False)
            y, aux = checkpoint(ffn_sub, x, lp, sp, use_reentrant=False)
            return x + y, aux
        return checkpoint(layer, x, lp, positions, is_global, sp,
                          use_reentrant=False)

    def trunk(params, tokens):
        """The embedding and the layers: (x, aux, sp), x this rank's
        sequence shard under ``sp``."""
        x = _embed(params, tokens, cfg, rank)
        b, s = x.shape[:2]
        sp = rank.seq_sharded(s)
        if sp:
            x = par.split(x, 1, rank.model)
        positions = torch.arange(s, device=x.device).expand(b, s)
        auxes = []
        for i, is_global in enumerate(flags):
            x, aux = run_layer(x, _layer_params(params["layers"], i),
                               positions, is_global, sp)
            auxes.append(aux)
        return x, torch.stack(auxes).sum() * cfg.aux_loss_coef, sp

    def forward(params, tokens):
        x, aux, sp = trunk(params, tokens)
        return _unembed(x, params, cfg, rank, sp), aux

    forward.rank, forward.trunk = rank, trunk
    return forward


def _vocab_parallel_nll(x, params, labels, cfg: LMConfig, rank: _Rank,
                        sp: bool) -> torch.Tensor:
    """Per-token logsumexp(logits) - logits[label] with the unembed split
    over the vocabulary: each rank takes its float32 logits' shard (the
    whole (B, S, V) logits are never gathered); the max is all-reduced
    (MAX, no gradient), the exponentials' sums and the label's logit (from
    the rank that holds it) are all-reduced (SUM)."""
    x = cm.rms_norm(x, rank.param(params["final_norm"], sp), cfg.norm_eps)
    x = rank.enter(x, True, sp)
    logits = torch.einsum("bsd,dv->bsv", x, params["unembed"]).float()
    m = par.all_reduce_(logits.detach().amax(dim=-1).contiguous(), rank.model,
                        dist.ReduceOp.MAX)
    total = par.reduce((logits - m[..., None]).exp().sum(dim=-1), rank.model)
    v_loc = logits.shape[-1]
    local = labels.long() - rank.index * v_loc
    inside = (local >= 0) & (local < v_loc)
    picked = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = par.reduce(torch.where(inside, picked, torch.zeros_like(picked)),
                      rank.model)
    return m + torch.log(total) - gold


def make_loss_fn(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """loss_fn(params, {"tokens", "labels"}) -> (nll + aux, {"nll", "aux"}),
    the next-token cross-entropy on float32 logits. On a mesh the nll is
    meaned over the batch axes (its gradient is this shard's: the train
    step means the gradients over them), and with a vocab-parallel unembed
    it is taken over the logits' shards (:func:`_vocab_parallel_nll`)."""
    forward = make_forward(cfg, mesh, batch_axes)
    rank = forward.rank

    def loss_fn(params, batch):
        labels = torch.as_tensor(batch["labels"],
                                 device=params["unembed"].device)
        if rank.unembed:
            x, aux, sp = forward.trunk(params, batch["tokens"])
            per_token = _vocab_parallel_nll(x, params, labels, cfg, rank, sp)
        else:
            logits, aux = forward(params, batch["tokens"])
            logits = logits.float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
            per_token = logz - gold
        nll = par.mean_batch(per_token.mean(), rank.batch)
        return nll + aux, {"nll": nll, "aux": aux}

    loss_fn.rank = rank
    return loss_fn


# ---------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def _cache_shape(cfg: LMConfig, batch: int, max_len: int) -> Tuple[int, ...]:
    return (cfg.n_layers, batch, max_len, cfg.n_kv_padded, cfg.head_dim)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None, kv_heads: Optional[int] = None
               ) -> Dict[str, Any]:
    """A zero KV cache on ``device`` (``None``: CUDA), ``pos`` 0;
    ``kv_heads``: a rank's kv heads (default all)."""
    dev = resolve_device(device)
    shape = list(_cache_shape(cfg, batch, max_len))
    if kv_heads is not None:
        shape[3] = kv_heads
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """``meta`` tensor view for dry runs (no allocation)."""
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.empty(shape, dtype=cfg.torch_dtype, device="meta"),
            "v": torch.empty(shape, dtype=cfg.torch_dtype, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def cache_pspecs(cfg: LMConfig, batch_axes) -> Dict[str, Tuple]:
    """KV cache sharding as mesh-axis tuples (``param_pspecs``' form):
    batch over the data axes, kv heads over model."""
    kv = (None, batch_axes, None, "model", None)
    return {"k": kv, "v": kv, "pos": ()}


def seq_cache_pspecs(batch_axes) -> Dict[str, Tuple]:
    """The KV cache under ``decode_seq_shard``: batch over the data axes,
    the sequence over model (the reference's decode cells)."""
    kv = (None, batch_axes, "model", None, None)
    return {"k": kv, "v": kv, "pos": ()}


def _serve_layers(cfg: LMConfig, params, x, rank: _Rank,
                  attend: Callable[[int, torch.Tensor, Dict, bool], torch.Tensor],
                  sp: bool = False):
    """The layer loop of prefill and decode: ``attend(i, x, lp, is_global)``
    is layer i's attention output."""
    for i, is_global in enumerate(_layer_flags(cfg)):
        lp = _layer_params(params["layers"], i)
        x = x + attend(i, x, lp, is_global)
        x = x + _ffn(x, lp, cfg, rank, sp)[0]
    return x


def make_decode_step(cfg: LMConfig, mesh=None,
                     batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """Returns decode(params, cache, tokens (B,S)) -> (logits (B,S,V),
    cache).

    Consumes ``cache``: the new K/V are written into ``cache["k"]`` and
    ``cache["v"]`` in place, and the returned cache holds those tensors
    with ``pos`` advanced by S. On a mesh: this rank's shards and its
    cache, placed by :func:`cache_pspecs` (kv heads where they divide
    "model"), or under ``decode_seq_shard`` by :func:`seq_cache_pspecs`
    with the heads whole (:func:`lm_param_specs` ``serving``): then each
    layer's attention is :func:`_seqpar_attend` and S must be 1."""
    rank = _Rank(cfg, mesh, batch_axes, serving=True)
    seqpar = cfg.decode_seq_shard and rank.n > 1

    @torch.no_grad()
    def decode(params, cache, tokens):
        pos = cache["pos"]
        x = _embed(params, tokens, cfg, rank)
        b, s = x.shape[:2]
        positions = (pos + torch.arange(s, device=x.device)).expand(b, s)
        if seqpar and s != 1:
            raise ValueError(f"seq-parallel decode is single-token; got {s}")

        def attend(i, x, lp, is_global):
            return _attention(x, lp, positions, cfg, is_global, rank,
                              kv_cache=(cache["k"][i], cache["v"][i]),
                              cache_pos=pos, seqpar=seqpar)[0]

        x = _serve_layers(cfg, params, x, rank, attend)
        logits = _unembed(x, params, cfg, rank, False)
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + s}

    return decode


def make_prefill(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",),
                 max_len: Optional[int] = None):
    """Returns prefill(params, tokens (B,S)) -> (last_logits (B,V), cache).

    Uses the forward-path attention (block-diagonal for chunked layers)
    while collecting the per-layer K/V into a fresh cache of ``max_len``
    positions (S if ``max_len`` is None or shorter). Only the last
    position's logits are computed: that is what serving needs, and it
    avoids a (B, S, V) logits buffer at 32k context. On a mesh the params
    are placed for serving (:func:`lm_param_specs`) and the cache is this
    rank's, as :func:`make_decode_step` takes it: its kv heads, or under
    ``decode_seq_shard`` its slice of the sequence (``max_len`` must then
    divide "model").
    """
    rank = _Rank(cfg, mesh, batch_axes, serving=True)
    seqpar = cfg.decode_seq_shard and rank.n > 1

    @torch.no_grad()
    def prefill(params, tokens):
        x = _embed(params, tokens, cfg, rank)
        b, s = x.shape[:2]
        total = max(max_len or s, s)
        sp = rank.seq_sharded(s)
        kv_heads = params["layers"]["wk"].shape[2]
        # Positions [lo, hi) of the prompt go into this rank's cache: all
        # of them, or under seqpar those of its slice of the sequence.
        n_pos, lo, hi = total, 0, s
        if seqpar:
            if total % rank.n:
                raise ValueError(f"a cache of {total} positions does not "
                                 f"split over a model axis of {rank.n}")
            n_pos = total // rank.n
            lo = min(rank.index * n_pos, s)
            hi = min(lo + n_pos, s)
        cache = init_cache(cfg, b, n_pos, device=x.device, kv_heads=kv_heads)
        positions = torch.arange(s, device=x.device).expand(b, s)
        if sp:
            x = par.split(x, 1, rank.model)

        def attend(i, x, lp, is_global):
            out, (k, v) = _attention(x, lp, positions, cfg, is_global, rank,
                                     sp=sp)
            cache["k"][i, :, :hi - lo] = k[:, lo:hi]
            cache["v"][i, :, :hi - lo] = v[:, lo:hi]
            return out

        x = _serve_layers(cfg, params, x, rank, attend, sp)
        last = x[:, -1:]
        if sp:                              # the last rank holds position S-1
            last = par.gather_out(last, 1, rank.model)[:, -1:]
        logits = _unembed(last, params, cfg, rank, False)[:, 0]
        cache["pos"] = torch.full((), s, dtype=torch.int32, device=x.device)
        return logits, cache

    return prefill


__all__ = ["LMConfig", "lm_param_table", "lm_rules", "lm_param_specs",
           "make_moe_ffn", "make_forward", "make_loss_fn", "init_cache",
           "cache_shapes", "cache_pspecs", "seq_cache_pspecs", "make_prefill",
           "make_decode_step"]
