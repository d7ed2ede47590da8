"""Configuration registry of the PyTorch port: ``--arch <id>`` resolution
and the shape cells, the port's copy of the JAX package's ``configs``.

Each registered id is a module exposing ``ARCH_ID``, ``FAMILY``,
``config()`` (the published configuration) and ``smoke_config()`` (a
reduced same-family configuration for CPU tests). Ported: the dehaze ids
(the paper's own pipeline), the vision family (``vit-l16``,
``efficientnet-b7``, ``resnet-50``, ``convnext-b``) and the LM family
(``moonshot-v1-16b-a3b``, ``llama4-scout-17b-a16e``, ``granite-20b``,
``llama3-8b``) and the diffusion family (``dit-l2``, ``unet-sdxl``): the
ten ids of ``ASSIGNED_ARCHS`` and the two dehaze ids. The dehaze shapes
mirror the paper's Table 1 resolutions plus a high-resolution stress
shape for spatial sharding; the vision shapes are the zoo's training and
serving cells, the LM shapes its training, prefill and decode cells, the
diffusion shapes its training and sampling cells.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.configs import (convnext_b, dehaze_cap, dehaze_dcp, dit_l2,
                                 efficientnet_b7, granite_20b, llama3_8b,
                                 llama4_scout_17b_a16e, moonshot_v1_16b_a3b,
                                 resnet_50, unet_sdxl, vit_l16)

ARCH_MODULES = {m.ARCH_ID: m for m in (
    moonshot_v1_16b_a3b, llama4_scout_17b_a16e, granite_20b, llama3_8b,
    dit_l2, unet_sdxl, vit_l16, efficientnet_b7, resnet_50, convnext_b,
    dehaze_dcp, dehaze_cap)}

ASSIGNED_ARCHS: Tuple[str, ...] = (
    "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "granite-20b",
    "llama3-8b", "dit-l2", "unet-sdxl", "vit-l16", "efficientnet-b7",
    "resnet-50", "convnext-b")

# shape name -> dict of shape parameters (per family)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1,
                      needs_subquadratic=True),
}
DIFFUSION_SHAPES = {
    "train_256": dict(kind="train", img_res=256, batch=256, steps=1000),
    "gen_1024": dict(kind="sample", img_res=1024, batch=4, steps=50),
    "gen_fast": dict(kind="sample", img_res=512, batch=16, steps=4),
    "train_1024": dict(kind="train", img_res=1024, batch=32, steps=1000),
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

FAMILY_SHAPES = {"lm": LM_SHAPES, "diffusion": DIFFUSION_SHAPES,
                 "vision": VISION_SHAPES, "dehaze": DEHAZE_SHAPES}

# Pure full-attention LM archs skip long_500k (documented; DESIGN.md §4).
SUBQUADRATIC_LMS = {"llama4-scout-17b-a16e"}


def get_module(arch_id: str):
    """The module of ``arch_id``; an unknown id raises ``KeyError``."""
    try:
        return ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCH_MODULES)}") from None


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


def all_cells(include_dehaze: bool = False) -> List[Tuple[str, str]]:
    """The assigned 40 (arch x shape) cells, in registry order."""
    archs = list(ASSIGNED_ARCHS)
    if include_dehaze:
        archs += ["dehaze-dcp", "dehaze-cap"]
    return [(a, s) for a in archs for s in shapes_for(a)]


__all__ = ["ARCH_MODULES", "ASSIGNED_ARCHS", "LM_SHAPES", "DIFFUSION_SHAPES",
           "VISION_SHAPES", "DEHAZE_SHAPES", "FAMILY_SHAPES",
           "SUBQUADRATIC_LMS", "get_module", "shapes_for", "cell_skip_reason",
           "all_cells"]
