"""Configuration registry of the PyTorch port: ``--arch <id>`` resolution
and the shape cells, the dehaze half of the JAX package's ``configs``.

Each registered id is a module exposing ``ARCH_ID``, ``FAMILY``,
``config()`` (the published configuration) and ``smoke_config()`` (a
reduced same-family configuration for CPU tests). The dehaze shapes
mirror the paper's Table 1 resolutions plus a high-resolution stress
shape for spatial sharding. The model zoo's ids are not ported yet:
:func:`get_module` says so.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import dehaze_cap, dehaze_dcp

ARCH_MODULES = {m.ARCH_ID: m for m in (dehaze_dcp, dehaze_cap)}

# shape name -> dict of shape parameters
DEHAZE_SHAPES = {
    "stream_240p": dict(kind="dehaze", height=240, width=320, batch=256),
    "stream_480p": dict(kind="dehaze", height=480, width=640, batch=256),
    "stream_576p": dict(kind="dehaze", height=576, width=1024, batch=128),
    "stream_2160p": dict(kind="dehaze", height=2160, width=3840, batch=32),
}

FAMILY_SHAPES = {"dehaze": DEHAZE_SHAPES}


def get_module(arch_id: str):
    """The module of ``arch_id``. Only the dehaze ids are ported: any
    other id (the model zoo's wait for its port) raises ``KeyError``."""
    try:
        return ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"ported: {sorted(ARCH_MODULES)}") from None


def shapes_for(arch_id: str) -> Dict[str, dict]:
    return FAMILY_SHAPES[get_module(arch_id).FAMILY]


def cell_skip_reason(arch_id: str, shape_name: str) -> Optional[str]:
    """Why the (arch, shape) cell is skipped, or None. Every dehaze cell
    runs: only the zoo's long-context cells have a reason."""
    shapes_for(arch_id)[shape_name]                  # names a cell
    return None


__all__ = ["ARCH_MODULES", "DEHAZE_SHAPES", "FAMILY_SHAPES",
           "get_module", "shapes_for", "cell_skip_reason"]
