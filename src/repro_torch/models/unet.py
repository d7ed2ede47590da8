"""SDXL-class U-Net (Podell et al., arXiv:2307.01952) -- unet-sdxl.

The port's copy of the JAX package's ``models/unet.py``. Latent-space
U-Net: ch=320, ch_mult=(1,2,4), 2 res blocks per level, spatial
transformers with per-level depth (1,2,10) (assigned config),
cross-attention to a 2048-d text context, GroupNorm+SiLU, time embedding
(+ pooled-context add-embedding, SDXL style).

The architecture is *plan-driven*: :func:`build_plan` simulates the
skip-stack channel flow once and emits a flat list of typed block
descriptors; the param table and the forward pass both walk that plan, so
they cannot disagree. A transformer stack's params stay stacked on a
leading axis and the forward loops over it (the reference scans it, under
``jax.checkpoint`` when ``remat``): with ``remat`` each block recomputes
in the backward pass (``torch.utils.checkpoint``) while grad is enabled.
The attention runs in query chunks (``common.full_attention``): at
1024 px the first level's 16384 tokens would otherwise hold 42.9 GB of
float32 scores at a CFG batch of 8 (5 heads). The feed-forward GEGLU
takes the gate first, and the upsample is nearest at exactly 2x (pixel
``i`` reads ``i // 2``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str = "unet"
    img_res: int = 1024
    latent_ch: int = 4
    ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    n_res_blocks: int = 2
    transformer_depth: Tuple[int, ...] = (1, 2, 10)
    ctx_dim: int = 2048
    ctx_len: int = 77
    head_dim: int = 64
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    @property
    def t_dim(self) -> int:
        return self.ch * 4


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    kind: str                  # res | attn | down | up
    name: str
    cin: int = 0
    cout: int = 0
    depth: int = 0             # transformer depth for attn
    skip: int = 0              # channels popped from the skip stack (res-up)


def build_plan(c: UNetConfig) -> Tuple[List[Block], List[Block], List[Block]]:
    """Returns (down_plan, mid_plan, up_plan)."""
    chs = [c.ch * m for m in c.ch_mult]
    down: List[Block] = []
    stack = [c.ch]                       # conv_in output
    cur = c.ch
    for lvl, ch in enumerate(chs):
        for i in range(c.n_res_blocks):
            down.append(Block("res", f"d{lvl}_res{i}", cur, ch))
            cur = ch
            if c.transformer_depth[lvl]:
                down.append(Block("attn", f"d{lvl}_attn{i}", cur, cur,
                                  depth=c.transformer_depth[lvl]))
            stack.append(cur)
        if lvl < len(chs) - 1:
            down.append(Block("down", f"d{lvl}_down", cur, cur))
            stack.append(cur)
    mid = [Block("res", "mid_res0", cur, cur),
           Block("attn", "mid_attn", cur, cur, depth=c.transformer_depth[-1]),
           Block("res", "mid_res1", cur, cur)]
    up: List[Block] = []
    for lvl in reversed(range(len(chs))):
        ch = chs[lvl]
        for i in range(c.n_res_blocks + 1):
            skip = stack.pop()
            up.append(Block("res", f"u{lvl}_res{i}", cur + skip, ch, skip=skip))
            cur = ch
            if c.transformer_depth[lvl]:
                up.append(Block("attn", f"u{lvl}_attn{i}", cur, cur,
                                depth=c.transformer_depth[lvl]))
        if lvl > 0:
            up.append(Block("up", f"u{lvl}_up", cur, cur))
    assert not stack
    return down, mid, up


# ---------------------------------------------------------------------------
# Param table
# ---------------------------------------------------------------------------

def _gn(ch, dt, lead=(), la=()):
    return {"s": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="ones"),
            "b": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="zeros")}


def _res_table(b: Block, c: UNetConfig, dt):
    t = {
        "gn1": _gn(b.cin, dt),
        "conv1": ParamSpec((3, 3, b.cin, b.cout), (None, None, None, "conv_out"), dt),
        "t_proj": ParamSpec((c.t_dim, b.cout), (None, "conv_out"), dt),
        "t_proj_b": ParamSpec((b.cout,), ("conv_out",), dt, init="zeros"),
        "gn2": _gn(b.cout, dt),
        "conv2": ParamSpec((3, 3, b.cout, b.cout), (None, None, None, "conv_out"), dt),
    }
    if b.cin != b.cout:
        t["skip_proj"] = ParamSpec((1, 1, b.cin, b.cout),
                                   (None, None, None, "conv_out"), dt)
    return t


def _attn_table(b: Block, c: UNetConfig, dt):
    ch, d = b.cout, b.depth
    lead, la = (d,), ("layers",)
    inner = {
        "ln1_s": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="ones"),
        "ln1_b": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="zeros"),
        "self_q": ParamSpec(lead + (ch, ch), la + (None, "heads_flat"), dt),
        "self_k": ParamSpec(lead + (ch, ch), la + (None, "heads_flat"), dt),
        "self_v": ParamSpec(lead + (ch, ch), la + (None, "heads_flat"), dt),
        "self_o": ParamSpec(lead + (ch, ch), la + ("heads_flat", None), dt),
        "ln2_s": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="ones"),
        "ln2_b": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="zeros"),
        "cross_q": ParamSpec(lead + (ch, ch), la + (None, "heads_flat"), dt),
        "cross_k": ParamSpec(lead + (c.ctx_dim, ch), la + (None, "heads_flat"), dt),
        "cross_v": ParamSpec(lead + (c.ctx_dim, ch), la + (None, "heads_flat"), dt),
        "cross_o": ParamSpec(lead + (ch, ch), la + ("heads_flat", None), dt),
        "ln3_s": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="ones"),
        "ln3_b": ParamSpec(lead + (ch,), la + ("conv_out",), dt, init="zeros"),
        "ff1": ParamSpec(lead + (ch, 8 * ch), la + (None, "mlp"), dt),
        "ff2": ParamSpec(lead + (4 * ch, ch), la + ("mlp", None), dt),
    }
    return {
        "gn": _gn(ch, dt),
        "proj_in": ParamSpec((ch, ch), (None, None), dt),
        "blocks": inner,
        "proj_out": ParamSpec((ch, ch), (None, None), dt, init="zeros"),
    }


def unet_param_table(c: UNetConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    down, mid, up = build_plan(c)
    t: Dict[str, Any] = {
        "conv_in": ParamSpec((3, 3, c.latent_ch, c.ch),
                             (None, None, None, "conv_out"), dt),
        "t_mlp1": ParamSpec((c.ch, c.t_dim), (None, None), dt),
        "t_mlp2": ParamSpec((c.t_dim, c.t_dim), (None, None), dt),
        "pool_proj": ParamSpec((c.ctx_dim, c.t_dim), (None, None), dt),
        "out_gn": _gn(c.ch, dt),
        "conv_out": ParamSpec((3, 3, c.ch, c.latent_ch),
                              (None, None, None, None), dt, init="zeros"),
    }
    for b in down + mid + up:
        if b.kind == "res":
            t[b.name] = _res_table(b, c, dt)
        elif b.kind == "attn":
            t[b.name] = _attn_table(b, c, dt)
        else:                                        # down | up: a 3x3 conv
            t[b.name] = ParamSpec((3, 3, b.cin, b.cout),
                                  (None, None, None, "conv_out"), dt)
    return t


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _silu(x, dt):
    """SiLU in float32, cast to ``dt``."""
    return F.silu(x.float()).to(dt)


def _resblock(p, x, t_emb, dt):
    h = _silu(cm.group_norm(x, p["gn1"]["s"], p["gn1"]["b"]), dt)
    h = cm.conv2d(h, p["conv1"])
    h = h + (_silu(t_emb, dt) @ p["t_proj"] + p["t_proj_b"])[:, None, None, :]
    h = _silu(cm.group_norm(h, p["gn2"]["s"], p["gn2"]["b"]), dt)
    h = cm.conv2d(h, p["conv2"])
    skip = cm.conv2d(x, p["skip_proj"]) if "skip_proj" in p else x
    return h + skip


def _mha(q_in, kv_in, wq, wk, wv, wo, head_dim):
    b, sq, _ = q_in.shape
    h = wq.shape[-1] // head_dim
    q = (q_in @ wq).reshape(b, sq, h, head_dim)
    k = (kv_in @ wk).reshape(b, kv_in.shape[1], h, head_dim)
    v = (kv_in @ wv).reshape(b, kv_in.shape[1], h, head_dim)
    o = cm.full_attention(q, k, v)
    return o.reshape(b, sq, -1).to(q_in.dtype) @ wo


def _transformer_block(h, ctx, lp, head_dim: int):
    y = cm.layer_norm(h, lp["ln1_s"], lp["ln1_b"])
    h = h + _mha(y, y, lp["self_q"], lp["self_k"], lp["self_v"], lp["self_o"],
                 head_dim)
    y = cm.layer_norm(h, lp["ln2_s"], lp["ln2_b"])
    h = h + _mha(y, ctx, lp["cross_q"], lp["cross_k"], lp["cross_v"],
                 lp["cross_o"], head_dim)
    y = cm.layer_norm(h, lp["ln3_s"], lp["ln3_b"])
    gate, val = (y @ lp["ff1"]).chunk(2, dim=-1)     # gate first
    ff = F.gelu(gate.float(), approximate="tanh").to(h.dtype) * val
    return h + ff @ lp["ff2"]


def _spatial_transformer(p, x, ctx, cfg: UNetConfig):
    b, hh, ww, ch = x.shape
    h = cm.group_norm(x, p["gn"]["s"], p["gn"]["b"])
    h = h.reshape(b, hh * ww, ch) @ p["proj_in"]

    def block(lp, h):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(_transformer_block, h, ctx, lp, cfg.head_dim,
                              use_reentrant=False), None
        return _transformer_block(h, ctx, lp, cfg.head_dim), None

    h, _ = cm.run_stacked(block, h, p["blocks"], training=False)
    h = h @ p["proj_out"]
    return x + h.reshape(b, hh, ww, ch)


def _upsample2x(x):
    """``jax.image.resize(x, (B, 2H, 2W, C), "nearest")``: pixel ``i``
    reads ``i // 2`` on both axes."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def make_forward(cfg: UNetConfig, mesh: Optional[Any] = None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",),
                 img_res: Optional[int] = None):
    """forward(params, latents (B,r,r,4), t (B,), ctx (B,77,2048),
    pooled (B,2048)) -> (B,r,r,4). ``mesh``, ``batch_axes`` and
    ``img_res`` are ignored, as the reference ignores them: the
    resolution is the latents'."""
    del mesh, batch_axes, img_res
    down, mid, up = build_plan(cfg)
    dt = cfg.torch_dtype

    def forward(params, latents, t, ctx, pooled):
        ctx = ctx.to(dt)
        t = torch.as_tensor(t, device=latents.device)
        t_emb = cm.timestep_embedding(t, cfg.ch).to(dt)
        t_emb = _silu(t_emb @ params["t_mlp1"], dt) @ params["t_mlp2"]
        t_emb = t_emb + pooled.to(dt) @ params["pool_proj"]

        x = cm.conv2d(latents.to(dt), params["conv_in"])
        hs = [x]
        for b in down:
            p = params[b.name]
            if b.kind == "res":
                x = _resblock(p, x, t_emb, dt)
                hs.append(x)
            elif b.kind == "attn":
                x = _spatial_transformer(p, x, ctx, cfg)
                hs[-1] = x
            else:                                     # down
                x = cm.conv2d(x, p, stride=2)
                hs.append(x)
        for b in mid:
            p = params[b.name]
            x = _resblock(p, x, t_emb, dt) if b.kind == "res" \
                else _spatial_transformer(p, x, ctx, cfg)
        for b in up:
            p = params[b.name]
            if b.kind == "res":
                x = _resblock(p, torch.cat([x, hs.pop()], dim=-1), t_emb, dt)
            elif b.kind == "attn":
                x = _spatial_transformer(p, x, ctx, cfg)
            else:                                     # up
                x = cm.conv2d(_upsample2x(x), p)
        assert not hs
        x = cm.group_norm(x, params["out_gn"]["s"], params["out_gn"]["b"])
        return cm.conv2d(_silu(x, dt), params["conv_out"])

    return forward


def make_loss_fn(cfg: UNetConfig, mesh=None, batch_axes=("data",),
                 img_res: Optional[int] = None):
    """Denoising MSE (eps-prediction) on ``batch["noise"]``."""
    forward = make_forward(cfg, mesh, batch_axes, img_res)

    def loss_fn(params, batch):
        z0, noise = batch["latents"], batch["noise"]
        abar = cm.cosine_abar(batch["timesteps"])
        zt = torch.sqrt(abar) * z0 + torch.sqrt(1 - abar) * noise
        eps_hat = forward(params, zt, batch["timesteps"], batch["context"],
                          batch["pooled"]).float()
        loss = (eps_hat - noise).square().mean()
        return loss, {"mse": loss}

    return loss_fn


def make_sample_step(cfg: UNetConfig, mesh=None, batch_axes=("data",),
                     img_res: Optional[int] = None, guidance: float = 7.5):
    """One classifier-free-guided DDIM step: (params, z_t, t, t_next, ctx,
    pooled). The CFG null is zero context and zero pooled."""
    forward = make_forward(cfg, mesh, batch_axes, img_res)

    @torch.no_grad()
    def sample_step(params, zt, t, t_next, ctx, pooled):
        z2 = torch.cat([zt, zt], dim=0)
        t2 = torch.cat([t, t], dim=0)
        c2 = torch.cat([ctx, torch.zeros_like(ctx)], dim=0)
        p2 = torch.cat([pooled, torch.zeros_like(pooled)], dim=0)
        eps_c, eps_u = forward(params, z2, t2, c2, p2).float().chunk(2, dim=0)
        return cm.ddim_update(zt, eps_u + guidance * (eps_c - eps_u), t, t_next)

    return sample_step
