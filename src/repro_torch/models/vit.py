"""ViT classifier (Dosovitskiy et al., arXiv:2010.11929) -- vit-l16.

The port's copy of the JAX package's ``models/vit.py``. Pre-LN encoder,
learned position embeddings, CLS token, GELU MLP (the tanh form, in the
model dtype). Attention scores and softmax in float32. The layers' params
are stacked on a leading axis and the forward loops over it (the
reference scans it, under ``jax.checkpoint`` when ``remat``, which leaves
a forward's values as they are).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit"
    img_res: int = 224
    patch: int = 16
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096
    n_classes: int = 1000
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        r = img_res or self.img_res
        return (r // self.patch) ** 2 + 1


def vit_param_table(c: ViTConfig, img_res: Optional[int] = None) -> Dict[str, Any]:
    dt = c.torch_dtype
    L, dm = c.n_layers, c.d_model
    hd = dm // c.n_heads
    n_tok = c.n_tokens(img_res)
    return {
        "patch_embed": ParamSpec((c.patch, c.patch, 3, dm),
                                 (None, None, None, "embed"), dt),
        "patch_bias": ParamSpec((dm,), ("embed",), dt, init="zeros"),
        "cls": ParamSpec((1, 1, dm), (None, None, "embed"), dt, init="zeros"),
        "pos_embed": ParamSpec((1, n_tok, dm), (None, None, "embed"), dt,
                               scale=0.02),
        "layers": {
            "ln1_s": ParamSpec((L, dm), ("layers", "embed"), dt, init="ones"),
            "ln1_b": ParamSpec((L, dm), ("layers", "embed"), dt, init="zeros"),
            "wq": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wk": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wv": ParamSpec((L, dm, c.n_heads, hd), ("layers", "embed", "heads", "head_dim"), dt),
            "wo": ParamSpec((L, c.n_heads, hd, dm), ("layers", "heads", "head_dim", "embed"), dt),
            "ln2_s": ParamSpec((L, dm), ("layers", "embed"), dt, init="ones"),
            "ln2_b": ParamSpec((L, dm), ("layers", "embed"), dt, init="zeros"),
            "w_in": ParamSpec((L, dm, c.d_ff), ("layers", "embed", "mlp"), dt),
            "b_in": ParamSpec((L, c.d_ff), ("layers", "mlp"), dt, init="zeros"),
            "w_out": ParamSpec((L, c.d_ff, dm), ("layers", "mlp", "embed"), dt),
            "b_out": ParamSpec((L, dm), ("layers", "embed"), dt, init="zeros"),
        },
        "final_ln_s": ParamSpec((dm,), ("embed",), dt, init="ones"),
        "final_ln_b": ParamSpec((dm,), ("embed",), dt, init="zeros"),
        "head": ParamSpec((dm, c.n_classes), ("embed", "vocab"), dt),
    }


def _encoder_block(x, lp, cfg: ViTConfig):
    h = cm.layer_norm(x, lp["ln1_s"], lp["ln1_b"])
    q, k, v = (cm.project_heads(h, lp[n]) for n in ("wq", "wk", "wv"))
    o = cm.full_attention(q, k, v).to(x.dtype)
    nh, hd, dm = lp["wo"].shape
    x = x + o.flatten(-2) @ lp["wo"].reshape(nh * hd, dm)
    h = cm.layer_norm(x, lp["ln2_s"], lp["ln2_b"])
    h = F.gelu(h @ lp["w_in"] + lp["b_in"], approximate="tanh")
    x = x + h.to(x.dtype) @ lp["w_out"] + lp["b_out"]
    return x


def make_forward(cfg: ViTConfig, mesh=None,
                 batch_axes: Optional[Tuple[str, ...]] = ("data",)):
    """Returns forward(params, images (B,R,R,3)) -> logits (B, n_classes)."""
    del mesh, batch_axes   # batch sharding comes from the caller's inputs

    def forward(params, images):
        x = cm.conv2d(images.to(cfg.torch_dtype), params["patch_embed"],
                      stride=cfg.patch, padding="VALID") + params["patch_bias"]
        b = x.shape[0]
        x = x.reshape(b, -1, cfg.d_model)
        cls = params["cls"].expand(b, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + params["pos_embed"]
        x, _ = cm.run_stacked(lambda lp, x: (_encoder_block(x, lp, cfg), None),
                              x, params["layers"], training=False)
        x = cm.layer_norm(x[:, 0], params["final_ln_s"], params["final_ln_b"])
        return x @ params["head"]

    return forward


def make_loss_fn(cfg: ViTConfig, mesh=None, batch_axes=("data",)):
    forward = make_forward(cfg, mesh, batch_axes)

    def loss_fn(params, batch):
        logits = forward(params, batch["images"]).float()
        nll = cm.softmax_xent(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"].long()).float().mean()
        return nll, {"nll": nll, "acc": acc}

    return loss_fn
