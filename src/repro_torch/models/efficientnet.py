"""EfficientNet (Tan & Le, arXiv:1905.11946) -- efficientnet-b7
(width_mult 2.0, depth_mult 3.1, img 600).

The port's copy of the JAX package's ``models/efficientnet.py``. MBConv
blocks (expand -> depthwise -> squeeze-excite -> project) with BatchNorm +
swish, swish and sigmoid in float32. Stage tails (identical repeat
blocks) keep their params stacked on a leading axis and the forward loops
over it (the reference scans it); running BN stats merge back via
``common.merge_bn_stats``. ``remat`` recomputes each tail block in the
backward pass when training (``torch.utils.checkpoint``); a forward's
values do not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec

# B0 stage spec: (expand, channels, repeats, stride, kernel)
_B0_STAGES = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
]


def _round_ch(ch: float, divisor: int = 8) -> int:
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return new


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    name: str = "efficientnet"
    img_res: int = 600
    width_mult: float = 2.0
    depth_mult: float = 3.1
    n_classes: int = 1000
    se_ratio: float = 0.25      # unused, as in the reference: SE width is cin // 4
    dtype: str = "float32"
    remat: bool = True          # recompute each tail MBConv when training

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)

    def stages(self) -> Tuple[Tuple[int, int, int, int, int], ...]:
        out = []
        for e, c, r, s, k in _B0_STAGES:
            out.append((e, _round_ch(c * self.width_mult),
                        math.ceil(r * self.depth_mult), s, k))
        return tuple(out)

    @property
    def stem_ch(self) -> int:
        return _round_ch(32 * self.width_mult)

    @property
    def head_ch(self) -> int:
        return _round_ch(1280 * self.width_mult)


def _mbconv_table(cin, cout, expand, kernel, dt, n=None):
    lead = (n,) if n else ()
    la = ("layers",) if n else ()
    mid = cin * expand
    se = max(1, int(cin * 0.25))

    def conv(k, ci, co, groups=1):
        return ParamSpec(lead + (k, k, ci // groups, co),
                         la + (None, None, None, "conv_out"), dt)

    def bn(c):
        return {key: ParamSpec(lead + v.shape, la + v.axes, v.dtype, v.init)
                for key, v in cm.bn_table(c, dt).items()}

    t: Dict[str, Any] = {}
    if expand != 1:
        t["expand"] = conv(1, cin, mid)
        t["bn_e"] = bn(mid)
    t["dw"] = ParamSpec(lead + (kernel, kernel, 1, mid),
                        la + (None, None, None, "conv_out"), dt)
    t["bn_dw"] = bn(mid)
    t["se_reduce"] = conv(1, mid, se)
    t["se_reduce_b"] = ParamSpec(lead + (se,), la + ("conv_out",), dt, init="zeros")
    t["se_expand"] = conv(1, se, mid)
    t["se_expand_b"] = ParamSpec(lead + (mid,), la + ("conv_out",), dt, init="zeros")
    t["project"] = conv(1, mid, cout)
    t["bn_p"] = bn(cout)
    return t


def efficientnet_param_table(c: EfficientNetConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    t: Dict[str, Any] = {
        "stem": ParamSpec((3, 3, 3, c.stem_ch), (None, None, None, "conv_out"), dt),
        "stem_bn": cm.bn_table(c.stem_ch, dt),
    }
    cin = c.stem_ch
    for i, (e, ch, r, s, k) in enumerate(c.stages()):
        t[f"stage{i}_first"] = _mbconv_table(cin, ch, e, k, dt)
        if r > 1:
            t[f"stage{i}_rest"] = _mbconv_table(ch, ch, e, k, dt, n=r - 1)
        cin = ch
    t["head_conv"] = ParamSpec((1, 1, cin, c.head_ch),
                               (None, None, None, "conv_out"), dt)
    t["head_bn"] = cm.bn_table(c.head_ch, dt)
    t["head"] = ParamSpec((c.head_ch, c.n_classes), (None, "vocab"), dt)
    t["head_bias"] = ParamSpec((c.n_classes,), (None,), dt, init="zeros")
    return t


def _swish(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _mbconv(p, x, stride, training, axis_name):
    new_p = dict(p)
    h = x
    if "expand" in p:
        h = cm.conv2d(h, p["expand"])
        h, new_p["bn_e"] = cm.bn_apply(p["bn_e"], h, training, axis_name)
        h = _swish(h, x.dtype)
    h = cm.depthwise_conv2d(h, p["dw"], stride=stride)
    h, new_p["bn_dw"] = cm.bn_apply(p["bn_dw"], h, training, axis_name)
    h = _swish(h, x.dtype)
    # Squeeze-excite.
    s = h.mean(dim=(1, 2), keepdim=True)
    s = cm.conv2d(s, p["se_reduce"]) + p["se_reduce_b"]
    s = _swish(s, x.dtype)
    s = cm.conv2d(s, p["se_expand"]) + p["se_expand_b"]
    h = h * torch.sigmoid(s.float()).to(x.dtype)
    h = cm.conv2d(h, p["project"])
    h, new_p["bn_p"] = cm.bn_apply(p["bn_p"], h, training, axis_name)
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h, new_p


def make_forward(cfg: EfficientNetConfig, mesh=None, batch_axes=("data",),
                 training: bool = False):
    """forward(params, images) -> (logits, params_with_new_bn_stats)."""
    # BatchNorm's statistics over the batch axes' group, as resnet's.
    axis_name = cm.batch_stats_group(mesh, batch_axes)

    def forward(params, images):
        new_params = dict(params)
        x = cm.conv2d(images.to(cfg.torch_dtype), params["stem"], stride=2)
        x, new_params["stem_bn"] = cm.bn_apply(params["stem_bn"], x,
                                               training, axis_name)
        x = _swish(x, cfg.torch_dtype)
        for i, (e, ch, r, s, k) in enumerate(cfg.stages()):
            x, new_params[f"stage{i}_first"] = _mbconv(
                params[f"stage{i}_first"], x, s, training, axis_name)
            if r > 1:
                def body(lp, x):
                    return _mbconv(lp, x, 1, training, axis_name)
                if cfg.remat and training:
                    plain = body

                    def body(lp, x):
                        return checkpoint(plain, lp, x, use_reentrant=False)
                x, new_params[f"stage{i}_rest"] = cm.run_stacked(
                    body, x, params[f"stage{i}_rest"], training)
        x = cm.conv2d(x, params["head_conv"])
        x, new_params["head_bn"] = cm.bn_apply(params["head_bn"], x,
                                               training, axis_name)
        x = _swish(x, cfg.torch_dtype)
        x = x.mean(dim=(1, 2))
        logits = x @ params["head"] + params["head_bias"]
        return logits, new_params

    return forward


def make_loss_fn(cfg: EfficientNetConfig, mesh=None, batch_axes=("data",)):
    forward = make_forward(cfg, mesh, batch_axes, training=True)

    def loss_fn(params, batch):
        logits, new_params = forward(params, batch["images"])
        nll = cm.softmax_xent(logits, batch["labels"])
        return nll, {"nll": nll, "bn_params": new_params}

    return loss_fn
