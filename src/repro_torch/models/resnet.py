"""ResNet (He et al., arXiv:1512.03385) -- resnet-50 (bottleneck 3-4-6-3).

The port's copy of the JAX package's ``models/resnet.py``. BatchNorm's
running stats live in the param tree and are merged back by the train
step (``common.merge_bn_stats``). Within a stage, identity blocks (2..n)
are homogeneous and keep their params stacked on a leading axis; the
forward loops over it (the reference scans it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet"
    img_res: int = 224
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    expansion: int = 4
    n_classes: int = 1000
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return cm.as_dtype(self.dtype)


def _conv_spec(k, cin, cout, dt):
    return ParamSpec((k, k, cin, cout), (None, None, None, "conv_out"), dt)


def _bottleneck_table(cin, mid, cout, dt, stride_first=False, n=None):
    """Param table for one bottleneck (or n stacked identical ones)."""
    lead = (n,) if n else ()
    lax_ = ("layers",) if n else ()

    def conv(k, ci, co):
        return ParamSpec(lead + (k, k, ci, co),
                         lax_ + (None, None, None, "conv_out"), dt)

    def bn(c):
        return {k: ParamSpec(lead + v.shape, lax_ + v.axes, v.dtype, v.init)
                for k, v in cm.bn_table(c, dt).items()}

    t = {
        "conv1": conv(1, cin, mid), "bn1": bn(mid),
        "conv2": conv(3, mid, mid), "bn2": bn(mid),
        "conv3": conv(1, mid, cout), "bn3": bn(cout),
    }
    if stride_first or cin != cout:
        t["proj"] = conv(1, cin, cout)
        t["bn_proj"] = bn(cout)
    return t


def resnet_param_table(c: ResNetConfig) -> Dict[str, Any]:
    dt = c.torch_dtype
    t: Dict[str, Any] = {
        "stem": _conv_spec(7, 3, c.width, dt),
        "stem_bn": cm.bn_table(c.width, dt),
    }
    cin = c.width
    for i, depth in enumerate(c.depths):
        mid = c.width * (2 ** i)
        cout = mid * c.expansion
        t[f"stage{i}_first"] = _bottleneck_table(
            cin, mid, cout, dt, stride_first=True)
        if depth > 1:
            t[f"stage{i}_rest"] = _bottleneck_table(
                cout, mid, cout, dt, n=depth - 1)
        cin = cout
    t["head"] = ParamSpec((cin, c.n_classes), (None, "vocab"), dt)
    t["head_bias"] = ParamSpec((c.n_classes,), (None,), dt, init="zeros")
    return t


def _bottleneck(p, x, stride, training, axis_name):
    y, bn1 = cm.bn_apply(p["bn1"], cm.conv2d(x, p["conv1"]), training,
                         axis_name)
    y = F.relu(y)
    y, bn2 = cm.bn_apply(p["bn2"], cm.conv2d(y, p["conv2"], stride=stride),
                         training, axis_name)
    y = F.relu(y)
    y, bn3 = cm.bn_apply(p["bn3"], cm.conv2d(y, p["conv3"]), training,
                         axis_name)
    new_p = dict(p, bn1=bn1, bn2=bn2, bn3=bn3)
    if "proj" in p:
        sc, bnp = cm.bn_apply(p["bn_proj"],
                              cm.conv2d(x, p["proj"], stride=stride),
                              training, axis_name)
        new_p["bn_proj"] = bnp
    else:
        sc = x
    return F.relu(y + sc), new_p


def make_forward(cfg: ResNetConfig, mesh=None, batch_axes=("data",),
                 training: bool = False):
    """forward(params, images) -> (logits, params_with_new_bn_stats)."""
    # The reference leaves its sync-BN axis unset (GSPMD takes the
    # statistics over the whole batch); the port means them over the batch
    # axes' group.
    axis_name = cm.batch_stats_group(mesh, batch_axes)

    def forward(params, images):
        new_params = dict(params)
        x = cm.conv2d(images.to(cfg.torch_dtype), params["stem"], stride=2)
        x, new_params["stem_bn"] = cm.bn_apply(params["stem_bn"], x,
                                               training, axis_name)
        x = F.relu(x)
        x = cm.max_pool(x, 3, 2)
        for i, depth in enumerate(cfg.depths):
            stride = 1 if i == 0 else 2
            x, new_params[f"stage{i}_first"] = _bottleneck(
                params[f"stage{i}_first"], x, stride, training, axis_name)
            if depth > 1:
                x, new_params[f"stage{i}_rest"] = cm.run_stacked(
                    lambda lp, x: _bottleneck(lp, x, 1, training, axis_name),
                    x, params[f"stage{i}_rest"], training)
        x = x.mean(dim=(1, 2))
        logits = x @ params["head"] + params["head_bias"]
        return logits, new_params

    return forward


def make_loss_fn(cfg: ResNetConfig, mesh=None, batch_axes=("data",)):
    forward = make_forward(cfg, mesh, batch_axes, training=True)

    def loss_fn(params, batch):
        logits, new_params = forward(params, batch["images"])
        nll = cm.softmax_xent(logits, batch["labels"])
        return nll, {"nll": nll, "bn_params": new_params}

    return loss_fn
