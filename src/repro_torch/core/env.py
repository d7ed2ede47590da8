"""``REPRO_*`` environment accessors the port's serving path reads.

The same knobs, values and errors as the JAX package's ``core.env``:
unknown or malformed values raise ``ValueError`` instead of silently
selecting another code path.

  REPRO_KERNEL_MODE      execution substrate / pipeline mode override
  REPRO_LANE_NATIVE      force the lane-native megakernel on (1) or off (0)
  REPRO_TICK_OVERLAP     force the zero-copy overlapped serve tick on (1) or
                         off (0)
  REPRO_STEP_CACHE_SIZE  bounded LRU size of the serving step cache
  REPRO_TORCH_KERNEL_TUNING
                         path of the port's kernel-tuning table (its own, so
                         the port never reads or writes the JAX package's
                         ``REPRO_KERNEL_TUNING`` table)
  REPRO_TUNE_<OP>        per-op JSON tile-parameter override
  REPRO_TUNE_DEVICE_KIND override the device-kind key tuned winners
                         persist and resolve under
  REPRO_TUNE_REQUIRE_TABLE
                         when '1', ``tuning.get_params`` raises if neither a
                         table entry nor an env override exists
  REPRO_BENCH_SMOKE      benchmarks use tiny shapes when set (the
                         reference's knob; the port has no benchmark yet)

``snapshot()`` / ``restore()`` capture and reinstate the whole ``REPRO_*``
environment for test isolation.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

SUBSTRATES = ("ref", "pallas", "interpret")
KERNEL_MODES = SUBSTRATES + ("fused", "auto")

_TUNING_DEFAULT_PATH = Path("results") / "kernel_tuning_torch.json"


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


def tuning_table_path() -> Path:
    """``REPRO_TORCH_KERNEL_TUNING``: path of the port's tuning table,
    default ``results/kernel_tuning_torch.json``."""
    return Path(os.environ.get("REPRO_TORCH_KERNEL_TUNING",
                               str(_TUNING_DEFAULT_PATH)))


def tune_override(op: str) -> Dict[str, Any]:
    """``REPRO_TUNE_<OP>``: JSON object of tile-parameter overrides for
    ``op``, ``{}`` when unset. Malformed JSON (or a non-object) is ignored,
    as the reference ignores it; a well-formed override naming a knob or a
    value the op does not take raises where it is resolved
    (``kernels.tuning.resolve``)."""
    env = os.environ.get(f"REPRO_TUNE_{op.upper()}")
    if not env:
        return {}
    try:
        params = json.loads(env)
    except ValueError:
        return {}
    return params if isinstance(params, dict) else {}


def tune_device_kind() -> str:
    """``REPRO_TUNE_DEVICE_KIND``: overrides the device-kind key measured
    tuning winners persist (and resolve) under, ``""`` when unset."""
    return os.environ.get("REPRO_TUNE_DEVICE_KIND", "")


def tune_require_table() -> bool:
    """``REPRO_TUNE_REQUIRE_TABLE``: when '1', ``tuning.get_params`` raises
    for lookups that found neither a measured table entry nor an env
    override. '0'/'1' or unset; anything else raises."""
    env = os.environ.get("REPRO_TUNE_REQUIRE_TABLE", "")
    if env not in ("", "0", "1"):
        raise ValueError(
            f"REPRO_TUNE_REQUIRE_TABLE={env!r} is not a valid value; "
            "expected '0', '1' or unset")
    return env == "1"


def bench_smoke() -> bool:
    """``REPRO_BENCH_SMOKE``: benchmarks shrink to smoke shapes when set to
    anything non-empty."""
    return bool(os.environ.get("REPRO_BENCH_SMOKE"))


def snapshot() -> Dict[str, str]:
    """Current values of every ``REPRO_*`` variable (for :func:`restore`)."""
    return {k: v for k, v in os.environ.items() if k.startswith("REPRO_")}


def restore(snap: Dict[str, str]) -> None:
    """Reinstate a :func:`snapshot`: variables added since are removed,
    changed ones reset."""
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        if k not in snap:
            del os.environ[k]
    os.environ.update(snap)


__all__ = ["SUBSTRATES", "KERNEL_MODES", "kernel_mode", "lane_native",
           "tick_overlap", "step_cache_size", "tuning_table_path",
           "tune_override", "tune_device_kind", "tune_require_table",
           "bench_smoke", "snapshot", "restore"]
