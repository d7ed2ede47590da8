"""ConvNeXt (Liu et al., arXiv:2201.03545) -- convnext-b.

The port's copy of the JAX package's ``models/convnext.py``. Stages are
homogeneous, their block params stacked on a leading axis (the forward
loops over it; the reference scans it). LayerNorm (channel-last), 7x7
depthwise, 4x pointwise MLP with the tanh GELU in float32, LayerScale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str = "convnext"
    img_res: int = 224
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    n_classes: int = 1000
    layerscale_init: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)


def _block_table(n, dim, dt):
    return {
        "dw": ParamSpec((n, 7, 7, 1, dim), ("layers", None, None, None, "conv_out"), dt),
        "ln_s": ParamSpec((n, dim), ("layers", "conv_out"), dt, init="ones"),
        "ln_b": ParamSpec((n, dim), ("layers", "conv_out"), dt, init="zeros"),
        "pw1": ParamSpec((n, dim, 4 * dim), ("layers", "conv_out", "mlp"), dt),
        "pw1_b": ParamSpec((n, 4 * dim), ("layers", "mlp"), dt, init="zeros"),
        "pw2": ParamSpec((n, 4 * dim, dim), ("layers", "mlp", "conv_out"), dt),
        "pw2_b": ParamSpec((n, dim), ("layers", "conv_out"), dt, init="zeros"),
        "gamma": ParamSpec((n, dim), ("layers", "conv_out"), dt, init="ones",
                           scale=1.0),
    }


def convnext_param_table(c: ConvNeXtConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    t: Dict[str, Any] = {
        "stem": ParamSpec((4, 4, 3, c.dims[0]), (None, None, None, "conv_out"), dt),
        "stem_ln_s": ParamSpec((c.dims[0],), ("conv_out",), dt, init="ones"),
        "stem_ln_b": ParamSpec((c.dims[0],), ("conv_out",), dt, init="zeros"),
    }
    for i, (d, dim) in enumerate(zip(c.depths, c.dims)):
        t[f"stage{i}"] = _block_table(d, dim, dt)
        if i < len(c.depths) - 1:
            t[f"down{i}_ln_s"] = ParamSpec((dim,), ("conv_out",), dt, init="ones")
            t[f"down{i}_ln_b"] = ParamSpec((dim,), ("conv_out",), dt, init="zeros")
            t[f"down{i}"] = ParamSpec((2, 2, dim, c.dims[i + 1]),
                                      (None, None, None, "conv_out"), dt)
    t["final_ln_s"] = ParamSpec((c.dims[-1],), ("conv_out",), dt, init="ones")
    t["final_ln_b"] = ParamSpec((c.dims[-1],), ("conv_out",), dt, init="zeros")
    t["head"] = ParamSpec((c.dims[-1], c.n_classes), (None, "vocab"), dt)
    t["head_bias"] = ParamSpec((c.n_classes,), (None,), dt, init="zeros")
    return t


def _block(x, lp, ls_init):
    y = cm.depthwise_conv2d(x, lp["dw"])
    y = cm.layer_norm(y, lp["ln_s"], lp["ln_b"])
    y = y @ lp["pw1"] + lp["pw1_b"]
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    y = y @ lp["pw2"] + lp["pw2_b"]
    return x + (ls_init * lp["gamma"]) * y


def make_forward(cfg: ConvNeXtConfig, mesh=None, batch_axes=("data",),
                 training: bool = False):
    """forward(params, images (B,R,R,3)) -> logits (B, n_classes)."""
    del training

    def forward(params, images):
        x = cm.conv2d(images.to(cfg.torch_dtype), params["stem"], stride=4,
                      padding="VALID")
        x = cm.layer_norm(x, params["stem_ln_s"], params["stem_ln_b"])
        for i in range(len(cfg.depths)):
            x, _ = cm.run_stacked(
                lambda lp, x: (_block(x, lp, cfg.layerscale_init), None),
                x, params[f"stage{i}"], training=False)
            if i < len(cfg.depths) - 1:
                x = cm.layer_norm(x, params[f"down{i}_ln_s"],
                                  params[f"down{i}_ln_b"])
                x = cm.conv2d(x, params[f"down{i}"], stride=2, padding="VALID")
        x = x.mean(dim=(1, 2))
        x = cm.layer_norm(x, params["final_ln_s"], params["final_ln_b"])
        return x @ params["head"] + params["head_bias"]

    return forward


def make_loss_fn(cfg: ConvNeXtConfig, mesh=None, batch_axes=("data",)):
    forward = make_forward(cfg, mesh, batch_axes, training=True)

    def loss_fn(params, batch):
        nll = cm.softmax_xent(forward(params, batch["images"]),
                              batch["labels"])
        return nll, {"nll": nll}

    return loss_fn
