"""``REPRO_*`` environment accessors the port's serving path reads.

The same knobs, values and errors as the JAX package's ``core.env``:
unknown or malformed values raise ``ValueError`` instead of silently
selecting another code path.

  REPRO_KERNEL_MODE      execution substrate / pipeline mode override
  REPRO_LANE_NATIVE      force the lane-native megakernel on (1) or off (0)
  REPRO_TICK_OVERLAP     force the zero-copy overlapped serve tick on (1) or
                         off (0)
  REPRO_STEP_CACHE_SIZE  bounded LRU size of the serving step cache
"""
from __future__ import annotations

import os
from typing import Optional

SUBSTRATES = ("ref", "pallas", "interpret")
KERNEL_MODES = SUBSTRATES + ("fused", "auto")


def kernel_mode() -> str:
    """``REPRO_KERNEL_MODE``: a mode from :data:`KERNEL_MODES`, or ``""``
    when unset. Unknown values raise."""
    env = os.environ.get("REPRO_KERNEL_MODE", "")
    if env and env not in KERNEL_MODES:
        raise ValueError(
            f"REPRO_KERNEL_MODE={env!r} is not a valid kernel mode; "
            f"expected one of {sorted(KERNEL_MODES)}, or unset it")
    return env


def lane_native() -> Optional[bool]:
    """``REPRO_LANE_NATIVE``: ``True`` (force lane-native), ``False``
    (force the per-lane path) or ``None`` when unset. Unknown values
    raise."""
    env = os.environ.get("REPRO_LANE_NATIVE", "")
    if env not in ("", "0", "1"):
        raise ValueError(
            f"REPRO_LANE_NATIVE={env!r} is not a valid override; expected "
            "'0' (force per-lane), '1' (force lane-native) or unset")
    return None if env == "" else env == "1"


def tick_overlap() -> Optional[bool]:
    """``REPRO_TICK_OVERLAP``: ``True`` (force the zero-copy overlapped
    serve tick path), ``False`` (force the blocking path, the parity
    oracle) or ``None`` when unset. Unknown values raise. The port
    implements donation itself (``stream.iobuf.donation_supported``), so
    a forced overlap is always honoured; ``launch/serve.py
    --expect-overlap`` fails a serve in which a tick took the blocking
    path all the same."""
    env = os.environ.get("REPRO_TICK_OVERLAP", "")
    if env not in ("", "0", "1"):
        raise ValueError(
            f"REPRO_TICK_OVERLAP={env!r} is not a valid override; expected "
            "'0' (force blocking), '1' (force overlap) or unset")
    return None if env == "" else env == "1"


def step_cache_size(default: int = 8) -> int:
    """``REPRO_STEP_CACHE_SIZE``: max entries in the bounded LRU step
    cache. Must parse as a positive integer."""
    env = os.environ.get("REPRO_STEP_CACHE_SIZE", "")
    if not env:
        return default
    try:
        size = int(env)
    except ValueError:
        raise ValueError(
            f"REPRO_STEP_CACHE_SIZE={env!r} is not an integer") from None
    if size < 1:
        raise ValueError(
            f"REPRO_STEP_CACHE_SIZE must be >= 1, got {size}")
    return size


__all__ = ["SUBSTRATES", "KERNEL_MODES", "kernel_mode", "lane_native",
           "tick_overlap", "step_cache_size"]
