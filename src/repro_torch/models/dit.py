"""DiT (Peebles & Xie, arXiv:2212.09748) -- dit-l2 (DiT-L/2).

The port's copy of the JAX package's ``models/dit.py``. Latent-space
diffusion transformer with adaLN-zero conditioning on (timestep, class).
Operates on VAE latents at img_res/8; patch size 2. Predicts (eps, sigma)
-- 2x latent channels -- like the paper (learn_sigma=True).

The layers' params stay stacked on a leading axis and the forward loops
over it (the reference scans it, under ``jax.checkpoint`` when ``remat``):
with ``remat`` each layer recomputes in the backward pass
(``torch.utils.checkpoint``) while grad is enabled, which gives the
gradients of ``remat=False``. The attention runs in query chunks
(``common.full_attention``), so ``gen_1024``'s 4096 tokens do not hold
all their float32 scores at once. The LayerNorm here has no affine and
eps 1e-6; the MLP's GELU is the tanh form on the model-dtype product.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str = "dit"
    img_res: int = 256
    patch: int = 2
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    latent_ch: int = 4
    n_classes: int = 1000
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        r = (img_res or self.img_res) // 8
        return (r // self.patch) ** 2


def dit_param_table(c: DiTConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    L, dm = c.n_layers, c.d_model
    hd = dm // c.n_heads
    pdim = c.patch * c.patch * c.latent_ch
    return {
        "patch_embed": ParamSpec((pdim, dm), (None, "embed"), dt),
        "t_mlp1": ParamSpec((256, dm), (None, "embed"), dt),
        "t_mlp2": ParamSpec((dm, dm), ("embed", None), dt),
        "y_embed": ParamSpec((c.n_classes + 1, dm), ("vocab", "embed"), dt),
        "layers": {
            "wq": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wk": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wv": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wo": ParamSpec((L, c.n_heads, hd, dm), ("layers", "heads", "head_dim", "embed"), dt),
            "w_in": ParamSpec((L, dm, 4 * dm), ("layers", "embed", "mlp"), dt),
            "w_out": ParamSpec((L, 4 * dm, dm), ("layers", "mlp", "embed"), dt),
            # adaLN-zero: 6 modulation vectors from conditioning.
            "ada_w": ParamSpec((L, dm, 6 * dm), ("layers", "embed", None), dt,
                               init="zeros"),
            "ada_b": ParamSpec((L, 6 * dm), ("layers", None), dt, init="zeros"),
        },
        "final_ada_w": ParamSpec((dm, 2 * dm), ("embed", None), dt, init="zeros"),
        "final_ada_b": ParamSpec((2 * dm,), (None,), dt, init="zeros"),
        "final_proj": ParamSpec((dm, 2 * pdim), ("embed", None), dt,
                                init="zeros"),
    }


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _ln(x):
    """LayerNorm without affine, in float32, eps 1e-6, cast back."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _block(x, c_emb, lp, cfg: DiTConfig):
    mod = c_emb @ lp["ada_w"] + lp["ada_b"]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(_ln(x), sh1, sc1)
    q, k, v = (cm.project_heads(h, lp[n]) for n in ("wq", "wk", "wv"))
    o = cm.full_attention(q, k, v).to(x.dtype)
    nh, hd, dm = lp["wo"].shape
    attn = o.flatten(-2) @ lp["wo"].reshape(nh * hd, dm)
    x = x + g1[:, None, :] * attn
    h = _modulate(_ln(x), sh2, sc2)
    h = F.gelu(h @ lp["w_in"], approximate="tanh")
    mlp = h.to(x.dtype) @ lp["w_out"]
    return x + g2[:, None, :] * mlp


def make_forward(cfg: DiTConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",),
                 img_res: Optional[int] = None):
    """forward(params, latents (B,r,r,C), t (B,), y (B,)) -> (B,r,r,2C).
    ``mesh`` and ``batch_axes`` are ignored, as the reference ignores
    them; ``img_res`` overrides the config's resolution."""
    del mesh, batch_axes
    r = (img_res or cfg.img_res) // 8
    g = r // cfg.patch
    p, c = cfg.patch, cfg.latent_ch
    dt = cfg.torch_dtype

    def layer(lp, x, c_emb):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(_block, x, c_emb, lp, cfg, use_reentrant=False)
        return _block(x, c_emb, lp, cfg)

    def forward(params, latents, t, y):
        b = latents.shape[0]
        # Patchify: (B, g, p, g, p, C) -> (B, g*g, p*p*C).
        x = latents.to(dt).reshape(b, g, p, g, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * c)
        x = x @ params["patch_embed"]
        x = x + cm.posemb_sincos_2d(g, g, cfg.d_model,
                                    device=x.device).to(dt)[None]

        t_emb = cm.timestep_embedding(torch.as_tensor(t, device=x.device),
                                      256).to(dt)
        t_emb = F.silu(t_emb @ params["t_mlp1"]) @ params["t_mlp2"]
        y_emb = cm.take_clipped(params["y_embed"], y)   # clipped ids
        c_emb = F.silu(t_emb + y_emb)

        x, _ = cm.run_stacked(lambda lp, x: (layer(lp, x, c_emb), None),
                              x, params["layers"], training=False)

        mod = c_emb @ params["final_ada_w"] + params["final_ada_b"]
        sh, sc = mod.chunk(2, dim=-1)
        x = _modulate(_ln(x), sh, sc) @ params["final_proj"]
        # Unpatchify to (B, r, r, 2C).
        x = x.reshape(b, g, g, p, p, 2 * c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, r, r, 2 * c)

    return forward


def make_loss_fn(cfg: DiTConfig, mesh=None, batch_axes=("data",),
                 img_res: Optional[int] = None):
    """Denoising MSE (eps-prediction) with a cosine-ish schedule;
    ``batch["noise"]`` is the noise (the step stays a function of its
    inputs)."""
    forward = make_forward(cfg, mesh, batch_axes, img_res)

    def loss_fn(params, batch):
        z0, noise = batch["latents"], batch["noise"]
        abar = cm.cosine_abar(batch["timesteps"])
        zt = torch.sqrt(abar) * z0 + torch.sqrt(1 - abar) * noise
        out = forward(params, zt, batch["timesteps"], batch["labels"]).float()
        loss = (out[..., :cfg.latent_ch] - noise).square().mean()
        return loss, {"mse": loss}

    return loss_fn


def make_sample_step(cfg: DiTConfig, mesh=None, batch_axes=("data",),
                     img_res: Optional[int] = None, guidance: float = 4.0):
    """One classifier-free-guided DDIM step: (params, z_t, t, t_next, y).
    The CFG null class is ``n_classes``, the class table's last row."""
    forward = make_forward(cfg, mesh, batch_axes, img_res)

    @torch.no_grad()
    def sample_step(params, zt, t, t_next, y):
        y = torch.as_tensor(y, device=zt.device)
        z2 = torch.cat([zt, zt], dim=0)
        t2 = torch.cat([t, t], dim=0)
        y2 = torch.cat([y, torch.full_like(y, cfg.n_classes)], dim=0)
        out = forward(params, z2, t2, y2).float()
        eps_c, eps_u = out[..., :cfg.latent_ch].chunk(2, dim=0)
        return cm.ddim_update(zt, eps_u + guidance * (eps_c - eps_u), t, t_next)

    return sample_step
