"""Configuration registry of the PyTorch port: ``--arch <id>`` resolution
and the shape cells, the port's copy of the JAX package's ``configs``.

Each registered id is a module exposing ``ARCH_ID``, ``FAMILY``,
``config()`` (the published configuration) and ``smoke_config()`` (a
reduced same-family configuration for CPU tests). Ported: the dehaze ids
(the paper's own pipeline), the vision family (``vit-l16``,
``efficientnet-b7``, ``resnet-50``, ``convnext-b``) and the LM family
(``moonshot-v1-16b-a3b``, ``llama4-scout-17b-a16e``, ``granite-20b``,
``llama3-8b``). The dehaze shapes mirror the paper's Table 1 resolutions
plus a high-resolution stress shape for spatial sharding; the vision
shapes are the zoo's training and serving cells, the LM shapes its
training, prefill and decode cells. The diffusion ids are not ported yet:
:func:`get_module` says so.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import (convnext_b, dehaze_cap, dehaze_dcp,
                                 efficientnet_b7, granite_20b, llama3_8b,
                                 llama4_scout_17b_a16e, moonshot_v1_16b_a3b,
                                 resnet_50, vit_l16)

ARCH_MODULES = {m.ARCH_ID: m for m in (
    moonshot_v1_16b_a3b, llama4_scout_17b_a16e, granite_20b, llama3_8b,
    vit_l16, efficientnet_b7, resnet_50, convnext_b, dehaze_dcp, dehaze_cap)}

# shape name -> dict of shape parameters (per family)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1,
                      needs_subquadratic=True),
}
VISION_SHAPES = {
    "cls_224": dict(kind="train", img_res=224, batch=256),
    "cls_384": dict(kind="train", img_res=384, batch=64),
    "serve_b1": dict(kind="serve", img_res=224, batch=1),
    "serve_b128": dict(kind="serve", img_res=224, batch=128),
}
DEHAZE_SHAPES = {
    "stream_240p": dict(kind="dehaze", height=240, width=320, batch=256),
    "stream_480p": dict(kind="dehaze", height=480, width=640, batch=256),
    "stream_576p": dict(kind="dehaze", height=576, width=1024, batch=128),
    "stream_2160p": dict(kind="dehaze", height=2160, width=3840, batch=32),
}

FAMILY_SHAPES = {"lm": LM_SHAPES, "vision": VISION_SHAPES,
                 "dehaze": DEHAZE_SHAPES}

# Pure full-attention LM archs skip long_500k (documented; DESIGN.md §4).
SUBQUADRATIC_LMS = {"llama4-scout-17b-a16e"}


def get_module(arch_id: str):
    """The module of ``arch_id``. Any id not ported (the diffusion ids
    wait for their port) raises ``KeyError``."""
    try:
        return ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(ARCH_MODULES)}") from None


def shapes_for(arch_id: str) -> Dict[str, dict]:
    return FAMILY_SHAPES[get_module(arch_id).FAMILY]


def cell_skip_reason(arch_id: str, shape_name: str) -> Optional[str]:
    """Why the (arch, shape) cell is skipped, or None: a pure
    full-attention LM skips ``long_500k``."""
    shape = shapes_for(arch_id)[shape_name]
    if shape.get("needs_subquadratic") and arch_id not in SUBQUADRATIC_LMS:
        return ("pure full-attention arch: long_500k requires "
                "sub-quadratic attention (DESIGN.md §4)")
    return None


__all__ = ["ARCH_MODULES", "LM_SHAPES", "VISION_SHAPES", "DEHAZE_SHAPES",
           "FAMILY_SHAPES", "SUBQUADRATIC_LMS", "get_module", "shapes_for",
           "cell_skip_reason"]
