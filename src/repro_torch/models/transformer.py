"""Decoder-only transformer LM: GQA, RoPE, MoE, KV cache, on one device.

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

Only the one-device path is ported. The factories take ``mesh=None``; a
mesh of more than one device (the model axis's expert all-to-all, its
replicated MoE body and ``psum``, sequence-parallel decode attention, the
residual stream's sequence sharding) raises ``NotImplementedError``.
``reduce_dtype`` names the dtype of the ``wo``/``w_down`` products'
cross-chip partial sums: on one card a bfloat16 product is cuBLAS's
float32 accumulation rounded once to bfloat16, either way.

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.pipeline import DeviceLike, resolve_device
from repro_torch.models import common as cm
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
    # Perf levers of the reference's multi-device paths; on one device
    # only remat_policy acts (see the module docstring).
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


def _mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a mapping of sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh)


def _one_device(mesh) -> None:
    """Raise unless ``mesh`` is None or holds one device."""
    if mesh is None:
        return
    sizes = _mesh_sizes(mesh)
    if sizes.get("model", 1) > 1:
        raise NotImplementedError("model axis not yet ported (A.7d)")
    if math.prod(sizes.values()) > 1:
        raise NotImplementedError(f"an LM mesh of {sizes} devices is not yet "
                                  "ported (A.7d); pass mesh=None")


# ---------------------------------------------------------------------------
# MoE FFN (sort-based dispatch)
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


def _moe_local(x, router, w_gate, w_up, w_down, *, cfg: LMConfig):
    """MoE body on one device. x: (T, dm); w_*: (E, ...). Returns (y: (T,
    dm), aux scalar)."""
    E, k = cfg.moe_experts, cfg.moe_topk
    t, dm = x.shape
    dev = x.device
    cap = max(1, math.ceil(t * k / E * cfg.moe_capacity_factor))

    top_w, top_e, probs = _route(x, router, cfg)

    flat_e = top_e.reshape(-1)                                   # (T*k,)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_t = flat_t[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos < cap
    slot_sorted = torch.where(keep, sorted_e * cap + pos,
                              torch.full_like(pos, E * cap))     # E*cap = drop

    # Dispatch: (E*cap, dm) buffers; dropped tokens go to a spare row.
    buf = x.new_zeros((E * cap + 1, dm)).index_copy(
        0, slot_sorted, x.index_select(0, sorted_t))[:E * cap]
    o = _expert_ffn(buf.reshape(E, cap, dm), w_gate, w_up, w_down,
                    x.dtype).reshape(E * cap, dm)

    # Combine: unsort slots back to (T, k), gather, weight, sum.
    slot_flat = torch.empty_like(slot_sorted).index_copy_(0, order, slot_sorted)
    picked = o.index_select(0, slot_flat.clamp(0, E * cap - 1))  # (T*k, dm)
    valid = (slot_flat < E * cap).to(x.dtype)
    w = (top_w.reshape(-1).to(x.dtype) * valid)[:, None]
    y = (picked * w).reshape(t, k, dm).sum(dim=1)
    return y, _aux_loss(top_e, probs, E)


def make_moe_ffn(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = None,
                 seq_len: Optional[int] = None):
    """Returns moe_ffn(x (B,S,dm), router, w_gate, w_up, w_down) -> (y,
    aux_loss), the one-device body (``_moe_local``)."""
    _one_device(mesh)

    def moe_ffn(x, router, w_gate, w_up, w_down):
        b, s, dm = x.shape
        y, aux = _moe_local(x.reshape(b * s, dm), router, w_gate, w_up,
                            w_down, cfg=cfg)
        return y.reshape(b, s, dm), aux

    return moe_ffn


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------

def _attention(x, lp, positions, cfg: LMConfig, is_global: bool,
               kv_cache=None, cache_pos=None):
    """One attention sublayer. Returns (out, (k_new, v_new)).

    Training/prefill: kv_cache None, positions (B, S).
    Decode: kv_cache (k, v) each (B, S_max, Kp, hd), written in place at
    ``clip(cache_pos, 0, S_max - S)`` (``dynamic_update_slice``'s clamp);
    cache_pos an int32 0-d tensor.
    """
    b, s, dm = x.shape
    h = cm.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, lp["wv"])

    # Plain causal archs: RoPE everywhere; llama4-style: chunked layers
    # use RoPE, global layers are NoPE.
    if cfg.chunk_attn == 0 or not is_global:
        q = cm.rope(q, positions, cfg.rope_theta)
        k = cm.rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if cfg.chunk_attn and s > cfg.chunk_attn and not is_global:
            w = cfg.chunk_attn
            n = s // w
            o = cm.causal_attention(q.reshape(b * n, w, *q.shape[2:]),
                                    k.reshape(b * n, w, *k.shape[2:]),
                                    v.reshape(b * n, w, *v.shape[2:]),
                                    kv_block=cfg.kv_block)
            o = o.reshape(b, s, *o.shape[2:])
        else:
            o = cm.causal_attention(q, k, v, kv_block=cfg.kv_block)
        k_out, v_out = k, v
    else:
        ck, cv = kv_cache
        s_max = ck.shape[1]
        ar = torch.arange(s, device=x.device)
        at = torch.clamp(cache_pos, 0, s_max - s).long() + ar
        k_out = ck.index_copy_(1, at, k)
        v_out = cv.index_copy_(1, at, v)
        if cfg.chunk_attn and cfg.chunk_attn < s_max and not is_global:
            w = cfg.chunk_attn
            start = torch.clamp(cache_pos + s - w, 0, s_max - w).long()
            win = start + torch.arange(w, device=x.device)
            o = cm.causal_attention(q, k_out.index_select(1, win),
                                    v_out.index_select(1, win),
                                    q_offset=cache_pos - start,
                                    kv_block=cfg.kv_block)
        else:
            o = cm.causal_attention(q, k_out, v_out, q_offset=cache_pos,
                                    kv_block=cfg.kv_block)
    out = torch.einsum("bshk,hkd->bsd", o, lp["wo"])
    return out.to(_accum_dtype(cfg)).to(x.dtype), (k_out, v_out)


def _accum_dtype(cfg: LMConfig) -> torch.dtype:
    """Dtype of the row-parallel (wo / w_down) products' partial sums."""
    return torch.bfloat16 if cfg.reduce_dtype == "bfloat16" else torch.float32


def _dense_ffn(x, lp, cfg: LMConfig):
    h = cm.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    g = torch.einsum("bsd,df->bsf", h, lp["w_gate"])
    u = torch.einsum("bsd,df->bsf", h, lp["w_up"])
    act = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", act, lp["w_down"]).to(
        _accum_dtype(cfg)).to(x.dtype)


def _ffn(x, lp, cfg: LMConfig, moe_ffn):
    """The FFN sublayer's output and its aux loss (0 for a dense FFN)."""
    if cfg.moe_experts:
        h = cm.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return moe_ffn(h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"])
    return _dense_ffn(x, lp, cfg), torch.zeros((), dtype=torch.float32,
                                               device=x.device)


def _layer_flags(cfg: LMConfig) -> Tuple[bool, ...]:
    """Per layer, True where it uses global (full, RoPE-less) attention."""
    if cfg.chunk_attn == 0:
        return (True,) * cfg.n_layers        # all global (plain causal)
    return tuple((i + 1) % cfg.global_every == 0 for i in range(cfg.n_layers))


def _layer_params(layers: Dict[str, torch.Tensor], i: int):
    return {k: v[i] for k, v in layers.items()}


def _embed(params, tokens, cfg: LMConfig) -> torch.Tensor:
    """Token ids looked up as the reference's ``embed.at[tokens].get(
    mode="clip")`` does (``common.take_clipped``), cast to the config's
    dtype."""
    return cm.take_clipped(params["embed"], tokens).to(cfg.torch_dtype)


def make_forward(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """Returns forward(params, tokens (B,S)) -> (logits, aux_loss)."""
    _one_device(mesh)
    moe_ffn = make_moe_ffn(cfg) if cfg.moe_experts else None
    flags = _layer_flags(cfg)

    def attn_sub(x, lp, positions, is_global):
        return _attention(x, lp, positions, cfg, is_global)[0]

    def ffn_sub(x, lp):
        return _ffn(x, lp, cfg, moe_ffn)

    def layer(x, lp, positions, is_global):
        x = x + attn_sub(x, lp, positions, is_global)
        y, aux = ffn_sub(x, lp)
        return x + y, aux

    def run_layer(x, lp, positions, is_global):
        if not (cfg.remat and torch.is_grad_enabled()):
            return layer(x, lp, positions, is_global)
        if cfg.remat_policy == "save_sums":
            x = x + checkpoint(attn_sub, x, lp, positions, is_global,
                               use_reentrant=False)
            y, aux = checkpoint(ffn_sub, x, lp, use_reentrant=False)
            return x + y, aux
        return checkpoint(layer, x, lp, positions, is_global,
                          use_reentrant=False)

    def forward(params, tokens):
        x = _embed(params, tokens, cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        auxes = []
        for i, is_global in enumerate(flags):
            x, aux = run_layer(x, _layer_params(params["layers"], i),
                               positions, is_global)
            auxes.append(aux)
        x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
        return logits, torch.stack(auxes).sum() * cfg.aux_loss_coef

    return forward


def make_loss_fn(cfg: LMConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """loss_fn(params, {"tokens", "labels"}) -> (nll + aux, {"nll", "aux"}),
    the next-token cross-entropy on float32 logits."""
    forward = make_forward(cfg, mesh, batch_axes)

    def loss_fn(params, batch):
        logits, aux = forward(params, batch["tokens"])
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (logz - gold).mean()
        return nll + aux, {"nll": nll, "aux": aux}

    return loss_fn


# ---------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def _cache_shape(cfg: LMConfig, batch: int, max_len: int) -> Tuple[int, ...]:
    return (cfg.n_layers, batch, max_len, cfg.n_kv_padded, cfg.head_dim)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """A zero KV cache on ``device`` (``None``: CUDA), ``pos`` 0."""
    dev = resolve_device(device)
    shape = _cache_shape(cfg, batch, max_len)
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


def _serve_layers(cfg: LMConfig, params, x, moe_ffn,
                  attend: Callable[[int, torch.Tensor, Dict, bool], torch.Tensor]):
    """The layer loop of prefill and decode: ``attend(i, x, lp, is_global)``
    is layer i's attention output."""
    for i, is_global in enumerate(_layer_flags(cfg)):
        lp = _layer_params(params["layers"], i)
        x = x + attend(i, x, lp, is_global)
        x = x + _ffn(x, lp, cfg, moe_ffn)[0]
    return x


def make_decode_step(cfg: LMConfig, mesh=None,
                     batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """Returns decode(params, cache, tokens (B,S)) -> (logits (B,S,V),
    cache).

    Consumes ``cache``: the new K/V are written into ``cache["k"]`` and
    ``cache["v"]`` in place, and the returned cache holds those tensors
    with ``pos`` advanced by S."""
    _one_device(mesh)
    moe_ffn = make_moe_ffn(cfg) if cfg.moe_experts else None

    @torch.no_grad()
    def decode(params, cache, tokens):
        pos = cache["pos"]
        x = _embed(params, tokens, cfg)
        b, s = x.shape[:2]
        positions = (pos + torch.arange(s, device=x.device)).expand(b, s)

        def attend(i, x, lp, is_global):
            return _attention(x, lp, positions, cfg, is_global,
                              kv_cache=(cache["k"][i], cache["v"][i]),
                              cache_pos=pos)[0]

        x = _serve_layers(cfg, params, x, moe_ffn, attend)
        x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
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
    avoids a (B, S, V) logits buffer at 32k context.
    """
    _one_device(mesh)
    moe_ffn = make_moe_ffn(cfg) if cfg.moe_experts else None

    @torch.no_grad()
    def prefill(params, tokens):
        x = _embed(params, tokens, cfg)
        b, s = x.shape[:2]
        total = max(max_len or s, s)
        cache = init_cache(cfg, b, total, device=x.device)
        positions = torch.arange(s, device=x.device).expand(b, s)

        def attend(i, x, lp, is_global):
            out, (k, v) = _attention(x, lp, positions, cfg, is_global)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            return out

        x = _serve_layers(cfg, params, x, moe_ffn, attend)
        x = cm.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])[:, 0]
        cache["pos"] = torch.full((), s, dtype=torch.int32, device=x.device)
        return logits, cache

    return prefill


__all__ = ["LMConfig", "lm_param_table", "lm_rules", "make_moe_ffn",
           "make_forward", "make_loss_fn", "init_cache", "cache_shapes",
           "cache_pspecs", "make_prefill", "make_decode_step"]
