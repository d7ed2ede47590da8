"""Measured-search autotuner and device-kind-keyed tables of the port's
kernel knobs (the port of the JAX package's ``kernels/tuning.py``).

The knobs are the CUDA kernels' own, not the TPU's; the op names, the
table layout, the layering, the search and the CLI are the reference's.

  op (shape bucket)                       knobs, default first
  fused_dcp, fused_cap, fused_dcp_topk,   tile "32x64" | "64x32" (the
  fused_cap_topk (B, H, W),               megakernel's tiled passes, a
  fused_halo_2d (N, h, w)                 library variant each), blocks_per_sm
                                          3 | 2 (guided_ab's minimum blocks
                                          an SM, a variant too)
  fused_lanes (L, B, H, W)                the same, and grid_order
                                          "lane_major" | "frame_major" (the
                                          order of the grid's planes)
  atmolight, atmolight_topk (N, H, W)     tile_pixels 4096 | 2048 | 8192
                                          (B6a's and B6b's tile)

No knob changes an output bit (``csrc/fused_dehaze.cu``, ``csrc/staged.cu``);
they change where and when each output is computed.

Knobs resolve per (op, shape bucket) through a layered lookup, highest
priority first:

  1. env override    ``REPRO_TUNE_<OP>``, a JSON object, e.g.
                     ``REPRO_TUNE_FUSED_LANES='{"grid_order": "frame_major"}'``
  2. measured table  the entry for the device kind of the call's device
                     (``torch.cuda.get_device_name``, ``"cpu"`` for a CPU
                     device; override with ``REPRO_TUNE_DEVICE_KIND``) in
                     the port's JSON table, default
                     ``results/kernel_tuning_torch.json`` (path override
                     ``REPRO_TORCH_KERNEL_TUNING``: the port never reads
                     the JAX package's table); within a device kind the
                     dtype-tagged bucket (``...xu8``) layers over the
                     untagged float32 bucket
  3. legacy table    entries of a pre-schema-2 table (no device-kind key),
                     below any device-kind entry
  4. built-in default (:data:`DEFAULTS`, the kernels' constants before
                     they had knobs)

``REPRO_TUNE_REQUIRE_TABLE=1`` turns a lookup that found neither a table
entry nor an env override into :class:`AutotuneError`. :func:`get_params`
layers whatever the table and the override hold, as the reference does;
:func:`resolve`, what ``kernels.ops`` calls, checks the result
(:func:`check_params`: a knob or a value an op does not take raises
``ValueError`` naming it) and keeps it per (op, bucket, dtype, device
kind) while the table's file and the env knobs hold, so a serving loop
reads no table per tick.

The search is the reference's: :func:`measured_search` runs successive
halving (eta = 3) over the candidates, timing the whole population at
``start_iters`` iterations and keeping the fastest third each rung at
three times the iterations (capped at ``iters``), so its timed runs stay
below the exhaustive ``len(candidates) x iters`` of :func:`autotune` for
``iters >= 2``, with the same winner where the ranking does not depend
on the iteration count. A candidate that fails to build or run is
skipped and counted in ``skipped`` by exception type; one whose tiled
passes do not fit a block (:class:`TileDoesNotFit`) is skipped before it
is timed, since the wrapper would time the ten passes instead.

On a card the sweeps time by the card's own clock, not the host's: each
candidate's call is captured once in a CUDA graph and its replays are
timed by CUDA events (:func:`_replayable`, :func:`_time_callable`), and a
winner that is not the default is persisted only where it beats the
default, in :data:`CONFIRM_ROUNDS` rounds of turns (default, winner,
winner, default), by more than the turns' spread; else the default is
(its provenance keeps the turns under ``against_default``).
:func:`against_default` holds a committed entry to the same test. Winners
persist under ``{device_kinds: {kind: {op: {bucket: {params,
provenance}}}}}``. ``python -m repro_torch.kernels.tuning --search`` on
the card bakes real measurements into the table; ``--validate`` checks a
committed table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import env as _env
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import staged as _staged

_FUSED = {"tile": _fused.DEFAULT_TILE, "blocks_per_sm": _fused.BLOCKS_PER_SM[0]}

DEFAULTS: Dict[str, Dict[str, Any]] = {
    # The megakernel per algorithm and A-estimator (top-1 or top-k), as the
    # reference tunes them apart.
    "fused_dcp": dict(_FUSED),
    "fused_cap": dict(_FUSED),
    "fused_dcp_topk": dict(_FUSED),
    "fused_cap_topk": dict(_FUSED),
    # The halo stage of a spatial shard (B9): the tiled passes' masked form.
    "fused_halo_2d": dict(_FUSED),
    # The lane-native megakernel: the shape key holds the lane count.
    "fused_lanes": dict(_FUSED, grid_order=_fused.GRID_ORDERS[0]),
    "atmolight": {"tile_pixels": _staged.TOP1_TILE},
    "atmolight_topk": {"tile_pixels": _staged.TOP1_TILE},
}

#: The values each knob takes, default first.
KNOBS: Dict[str, Tuple[Any, ...]] = {
    "tile": tuple(_fused.TILES),
    "blocks_per_sm": _fused.BLOCKS_PER_SM,
    "grid_order": _fused.GRID_ORDERS,
    "tile_pixels": _staged.TOP1_TILES,
}

# Persisted-table schema version: entries keyed by device kind, each winner
# wrapped as {"params", "provenance"}; version-1 tables (bare
# {op: {bucket: params}}) still load through the legacy layer.
SCHEMA_VERSION = 2


class AutotuneError(RuntimeError):
    """Every candidate of a sweep failed to build or run (nothing is
    persisted), or ``REPRO_TUNE_REQUIRE_TABLE`` found no measurement."""


class TileDoesNotFit(ValueError):
    """A candidate's tiled passes need more shared memory than a block has:
    the wrapper would run (and the search would time) the ten passes."""


def table_path() -> Path:
    return _env.tuning_table_path()


_HW_KINDS: Dict[int, str] = {}


def device_kind(device=None) -> str:
    """The device-kind key winners persist (and resolve) under:
    ``REPRO_TUNE_DEVICE_KIND`` where set (read each call), else
    ``torch.cuda.get_device_name`` of ``device``'s card (cached per card),
    ``"cpu"`` for any other device. ``device=None`` is the current CUDA
    device where there is one, else the CPU."""
    env = _env.tune_device_kind()
    if env:
        return env
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    kind = _HW_KINDS.get(idx)
    if kind is None:
        kind = _HW_KINDS[idx] = torch.cuda.get_device_name(idx)
    return kind


# Wire-dtype tags: the float32 bucket is the bare shape; uint8 and bfloat16
# streams move other bytes a frame and get buckets of their own.
_DTYPE_TAGS = {"uint8": "u8", "bfloat16": "bf16"}


def _dtype_name(dtype) -> str:
    """``uint8``, ``bfloat16``, ``float32``, ... of a torch dtype, a numpy
    dtype (or type) or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def shape_bucket(shape: Iterable[int], dtype=None) -> str:
    key = "x".join(str(int(s)) for s in shape)
    tag = _DTYPE_TAGS.get(_dtype_name(dtype)) if dtype is not None else None
    return f"{key}x{tag}" if tag else key


# (path) -> (mtime, parsed table), so a lookup pays no parse while the file
# holds; ``table_reads`` counts the parses (``chip_smoke.py`` holds a
# tuned serve to none a tick), ``lookups`` the calls of get_params.
_TABLE_CACHE: Dict[str, tuple] = {}
table_reads = 0
lookups = 0


def load_table(path: Optional[Path] = None) -> Dict[str, Any]:
    global table_reads
    p = path or table_path()
    key = str(p)
    try:
        mtime = os.stat(p).st_mtime_ns
    except OSError:
        _TABLE_CACHE[key] = (None, {})
        return {}
    cached = _TABLE_CACHE.get(key)
    if cached and cached[0] == mtime:
        return cached[1]
    table_reads += 1
    try:
        with open(p) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    _TABLE_CACHE[key] = (mtime, table)
    return table


# Bumped by every save: mtime granularity can be coarser than a save and a
# lookup within one process.
_saves = 0


def save_table(table: Dict[str, Any], path: Optional[Path] = None) -> Path:
    global _saves
    p = path or table_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    _TABLE_CACHE[str(p)] = (os.stat(p).st_mtime_ns, table)
    _saves += 1
    return p


# ---------------------------------------------------------------------------
# Schema-2 table layout, legacy migration, lookup
# ---------------------------------------------------------------------------

_RESERVED_KEYS = ("schema", "device_kinds", "legacy")


def migrate_table(table: Dict[str, Any]) -> Dict[str, Any]:
    """Normalise any loaded table to the schema-2 layout: a version-1
    table's bare ``{op: {bucket: params}}`` go under ``"legacy"`` (never
    under a device kind: nothing says what measured them)."""
    if table.get("schema") == SCHEMA_VERSION:
        return table
    legacy_ops = {k: v for k, v in table.items() if k not in _RESERVED_KEYS}
    return {"schema": SCHEMA_VERSION,
            "device_kinds": dict(table.get("device_kinds", {})),
            "legacy": {**table.get("legacy", {}), **legacy_ops}}


def _entry_params(entry: Dict[str, Any]) -> Dict[str, Any]:
    """A table entry's params: schema-2 entries wrap them as ``{"params":
    ..., "provenance": ...}``, legacy entries are bare."""
    if "params" in entry and isinstance(entry["params"], dict):
        return entry["params"]
    return entry


def _table_layers(table: Dict[str, Any], kind: str
                  ) -> List[Dict[str, Dict[str, Any]]]:
    """``{op: {bucket: entry}}`` mappings lowest priority first: the legacy
    section, then the device kind's."""
    if table.get("schema") == SCHEMA_VERSION or "device_kinds" in table:
        legacy = table.get("legacy", {})
        kinds = table.get("device_kinds", {})
    else:                                   # version-1 file, unmigrated
        legacy = {k: v for k, v in table.items() if k not in _RESERVED_KEYS}
        kinds = {}
    return [legacy, kinds.get(kind, {})]


def get_params(op: str, shape: Iterable[int], dtype=None,
               device=None) -> Dict[str, Any]:
    """The knobs of ``op`` at ``shape`` on ``device``'s kind: env override
    > the device kind's table entry > legacy table entry > built-in
    default; within each table layer the dtype-tagged bucket over the
    untagged one, for the keys it sets. Whatever keys the layers hold
    are merged (:func:`resolve` checks them). With
    ``REPRO_TUNE_REQUIRE_TABLE=1`` a lookup that found neither a table
    entry nor an env override raises :class:`AutotuneError`."""
    global lookups
    lookups += 1
    params = dict(DEFAULTS.get(op, {}))
    table = load_table()
    buckets = [shape_bucket(shape)]
    tagged = shape_bucket(shape, dtype)
    if tagged != buckets[0]:
        buckets.append(tagged)
    kind = device_kind(device)
    found = False
    for layer in _table_layers(table, kind):
        entries = layer.get(op, {})
        for bucket in buckets:
            entry = entries.get(bucket)
            if entry:
                params.update(_entry_params(entry))
                found = True
    override = _env.tune_override(op)       # malformed JSON -> ignored
    params.update(override)
    if not found and not override and _env.tune_require_table():
        raise AutotuneError(
            f"REPRO_TUNE_REQUIRE_TABLE is set but no measured table entry "
            f"(device kind {kind!r}, buckets {buckets}, table "
            f"{table_path()}) or env override exists for op {op!r}: run "
            f"`python -m repro_torch.kernels.tuning --search` on this card")
    return params


def check_params(op: str, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` if every key is a knob of ``op`` and every value one it
    takes (:data:`KNOBS`, of the default's type); else ``ValueError``
    naming the first that is not. Returns ``params``."""
    if op not in DEFAULTS:
        raise ValueError(f"unknown tuning op {op!r}; expected one of "
                         f"{sorted(DEFAULTS)}")
    for key, value in params.items():
        if key not in DEFAULTS[op]:
            raise ValueError(
                f"{op}: {key!r} is not a knob of the port's kernels (its "
                f"knobs: {sorted(DEFAULTS[op])}); fix the tuning table "
                f"{table_path()} or REPRO_TUNE_{op.upper()}")
        choices = KNOBS[key]
        if type(value) is not type(choices[0]) or value not in choices:
            raise ValueError(
                f"{op}: {key}={value!r} is not a value the port's kernels "
                f"take ({list(choices)}); fix the tuning table "
                f"{table_path()} or REPRO_TUNE_{op.upper()}")
    return params


def state_token() -> tuple:
    """What resolved knobs depend on besides the op, shape, dtype and
    device: the table's path, its mtime and this process's saves, and every
    ``REPRO_TUNE_*`` variable. A holder of resolved knobs (a serve's cached
    step, ``kernels.ops``' ``tuned``) keeps them while this holds; reading
    it stats the table and walks the environment, so it is read once a
    serve, not once a call."""
    path = table_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    return (str(path), mtime, _saves,
            tuple(sorted((k, v) for k, v in os.environ.items()
                         if k.startswith("REPRO_TUNE_"))))


_RESOLVED: Dict[tuple, Dict[str, Any]] = {}
_RESOLVED_MAX = 256


def resolve(op: str, shape: Iterable[int], dtype=None,
            device=None) -> Dict[str, Any]:
    """:func:`get_params` checked by :func:`check_params`, made once per
    (op, bucket, dtype, device kind) while the table's path and mtime, the
    op's ``REPRO_TUNE_<OP>`` and ``REPRO_TUNE_REQUIRE_TABLE`` hold: a call
    after the first stats the table and reads two env variables, and
    parses nothing. The dict returned is shared: do not modify it."""
    path = table_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    key = (op, tuple(int(s) for s in shape),
           None if dtype is None else _dtype_name(dtype), device_kind(device),
           str(path), mtime, _saves, os.environ.get(f"REPRO_TUNE_{op.upper()}"),
           os.environ.get("REPRO_TUNE_REQUIRE_TABLE"))
    params = _RESOLVED.get(key)
    if params is None:
        params = check_params(op, get_params(op, shape, dtype, device))
        if len(_RESOLVED) >= _RESOLVED_MAX:
            _RESOLVED.clear()
        _RESOLVED[key] = params
    return params


def validate_table(table: Optional[Dict[str, Any]] = None,
                   path: Optional[Path] = None) -> List[str]:
    """Schema and provenance lint of a persisted table; returns error
    strings: the reference's checks (schema version, known op names,
    bucket-key grammar, wrapped ``{params, provenance}`` entries under
    ``device_kinds`` with the required provenance fields, bare param dicts
    under ``legacy``), and each device kind's params against
    :func:`check_params`."""
    if table is None:
        table = load_table(path)
    errors: List[str] = []
    if not table:
        return ["table is empty or unreadable"]
    if table.get("schema") != SCHEMA_VERSION:
        return [f"schema={table.get('schema')!r}, expected {SCHEMA_VERSION} "
                "(legacy tables load at runtime but do not validate — "
                "regenerate with `python -m repro_torch.kernels.tuning "
                "--search`)"]
    bucket_re = re.compile(r"^\d+(x\d+)*(xu8|xbf16)?$")
    required_prov = ("time_us", "iters", "considered", "skipped", "method")
    kinds = table.get("device_kinds")
    if not isinstance(kinds, dict) or not kinds:
        errors.append("device_kinds section missing or empty")
        kinds = {}
    for kind, ops_map in kinds.items():
        for op, entries in ops_map.items():
            if op not in DEFAULTS:
                errors.append(f"{kind}/{op}: unknown op")
            for bucket, entry in entries.items():
                where = f"{kind}/{op}/{bucket}"
                if not bucket_re.match(bucket):
                    errors.append(f"{where}: malformed bucket key")
                if not isinstance(entry, dict) \
                        or not isinstance(entry.get("params"), dict):
                    errors.append(f"{where}: entry must wrap a params dict")
                    continue
                if op in DEFAULTS:
                    try:
                        check_params(op, entry["params"])
                    except ValueError as e:
                        errors.append(f"{where}: {e}")
                prov = entry.get("provenance")
                if not isinstance(prov, dict):
                    errors.append(f"{where}: missing provenance")
                    continue
                for field in required_prov:
                    if field not in prov:
                        errors.append(f"{where}: provenance lacks {field!r}")
    for op, entries in table.get("legacy", {}).items():
        if op not in DEFAULTS:
            errors.append(f"legacy/{op}: unknown op")
        for bucket, entry in entries.items():
            if not bucket_re.match(bucket):
                errors.append(f"legacy/{op}/{bucket}: malformed bucket key")
            if not isinstance(entry, dict):
                errors.append(f"legacy/{op}/{bucket}: not a param dict")
    return errors


# ---------------------------------------------------------------------------
# Measurement and search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuneStats:
    """Cost ledger of one or more sweeps (accumulates): ``timed_runs``
    counts executions inside the search's timing loops, ``builds``
    candidates built and warmed, ``exhaustive_runs`` the ``len(candidates)
    x iters`` the exhaustive sweep would have timed over the same calls;
    ``skipped`` the candidates that failed, by exception type;
    ``confirm_runs`` the executions that held a winner against the default
    in turns (:data:`CONFIRM_ROUNDS`), apart from the search's own."""
    builds: int = 0
    timed_runs: int = 0
    rounds: int = 0
    considered: int = 0
    exhaustive_runs: int = 0
    skipped: Dict[str, int] = dataclasses.field(default_factory=dict)
    confirm_runs: int = 0

    def record_skip(self, exc: BaseException) -> None:
        name = type(exc).__name__
        self.skipped[name] = self.skipped.get(name, 0) + 1


def _tensors(out) -> Iterable[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _block(out) -> None:
    """Wait for the cards that ``out``'s CUDA tensors live on (the
    reference's ``block_until_ready``); nothing for anything else."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _graph_device(timer, device) -> Optional[torch.device]:
    """The card whose graphs the sweeps time (no ``timer`` given and a CUDA
    ``device``), else None."""
    return torch.device(device) if timer is None and _on_card(device) else None


def _replayable(fn: Callable[[], Any], device) -> Callable[[], None]:
    """One call of ``fn`` (built and warmed) captured in a CUDA graph on
    ``device``: its replay launches the same kernels on the same inputs
    without the wrapper's host work, so the card's clock times the kernels.
    A call that launches too little for its wrapper to keep ahead of the
    card (the megakernel at one lane, B9, B6a/B6b) times as the host's
    pace by events alone, and a knob cannot move that."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _time_callable(fn: Callable[[], Any], iters: int = 3,
                   timer: Optional[Callable[[], float]] = None,
                   warm: bool = True, stats: Optional[TuneStats] = None,
                   device=None) -> float:
    """Seconds a call of ``fn`` over ``iters`` calls. With a ``timer``, the
    reference's way: the clock read before the calls and after the last
    one finished. Without one, on a CUDA ``device`` the card's own clock:
    CUDA events around the calls, recorded behind one untimed lead call
    (the sweeps hand in a graph's replay, :func:`_replayable`); elsewhere
    ``time.perf_counter``."""
    if warm:
        _block(fn())                         # build + warm
    if timer is None and _on_card(device):
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()                                 # the lead call
        start.record(stream)
        for _ in range(iters):
            fn()
        end.record(stream)
        end.synchronize()
        t = start.elapsed_time(end) / 1e3 / iters
    else:
        timer = timer or time.perf_counter
        t0 = timer()
        out = None
        for _ in range(iters):
            out = fn()
        _block(out)
        t = (timer() - t0) / iters
    if stats is not None:
        stats.timed_runs += iters
    return t


#: Rounds of turns (default, candidate, candidate, default) that hold a
#: sweep's winner against the default before it is persisted.
CONFIRM_ROUNDS = 4


def _turns(default_fn: Callable, fn: Callable, rounds: int, iters: int,
           timer=None, device=None) -> Dict[str, List[float]]:
    """``rounds`` rounds of (default, candidate, candidate, default), each
    a :func:`_time_callable` of ``iters`` calls: the seconds a call, by
    name."""
    t: Dict[str, List[float]] = {"default": [], "candidate": []}
    for _ in range(rounds):
        for name, f in (("default", default_fn), ("candidate", fn),
                        ("candidate", fn), ("default", default_fn)):
            t[name].append(_time_callable(f, iters=iters, timer=timer,
                                          warm=False, device=device))
    return t


def _verdict(turns: Dict[str, List[float]]) -> Dict[str, Any]:
    """The turns' medians and their spread (the wider of the two samples'
    ranges), in µs; the candidate is ``faster`` only where it beats the
    default's median by more than the spread, ``slower`` where it trails
    it by more."""
    d, c = turns["default"], turns["candidate"]
    md, mc = statistics.median(d), statistics.median(c)
    spread = max(max(d) - min(d), max(c) - min(c))
    return {"default_us": round(md * 1e6, 3), "candidate_us": round(mc * 1e6, 3),
            "spread_us": round(spread * 1e6, 3), "rounds": len(d) // 2,
            "faster": md - mc > spread, "slower": mc - md > spread}


def _hold_against_default(op: str, best: Dict[str, Any], best_t: float,
                          pool, confirm: int, iters: int, timer, device,
                          stats: TuneStats):
    """``(params, seconds, verdict)`` to persist: ``best`` where it is the
    default or no rounds are asked for; else ``best`` only where it beats
    the default (when the default is in ``pool``) by more than the spread
    of ``confirm`` rounds of turns, the default otherwise."""
    default = DEFAULTS.get(op)
    dfn = next((f for p, f in pool if p == default), None)
    if not confirm or best == default or dfn is None:
        return best, best_t, None
    fn = next(f for p, f in pool if p == best)
    verdict = dict(_verdict(_turns(dfn, fn, confirm, iters, timer, device)),
                   candidate=best)
    stats.confirm_runs += 4 * confirm * iters
    if verdict["faster"]:
        return best, verdict["candidate_us"] / 1e6, verdict
    return dict(default), verdict["default_us"] / 1e6, verdict


def _provenance(best_t: float, iters: int, considered: int,
                skipped: Dict[str, int], method: str, device=None,
                verdict: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    prov = {"time_us": round(best_t * 1e6, 3), "iters": iters,
            "considered": considered, "skipped": skipped,
            "method": method, "device_kind": device_kind(device),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    if verdict is not None:
        prov["against_default"] = verdict
    return prov


def _stats_delta(stats: TuneStats, c0: int, skip0: Dict[str, int]
                 ) -> Tuple[int, Dict[str, int]]:
    """This call's own considered and skipped counts (one
    :class:`TuneStats` accumulates across ops; each entry's provenance
    describes its own sweep)."""
    skipped = {k: v - skip0.get(k, 0) for k, v in stats.skipped.items()
               if v - skip0.get(k, 0)}
    return stats.considered - c0, skipped


def _persist_winner(op: str, shape: Iterable[int], dtype,
                    params: Dict[str, Any], provenance: Dict[str, Any],
                    device=None) -> None:
    table = migrate_table(load_table())
    table["device_kinds"].setdefault(device_kind(device), {}).setdefault(op, {})[
        shape_bucket(shape, dtype)] = {"params": params,
                                       "provenance": provenance}
    save_table(table)


def _build_pool(op: str, shape, dtype, candidates, build,
                stats: TuneStats, replay: Optional[torch.device] = None
                ) -> List[Tuple[Dict[str, Any], Callable]]:
    """Build and warm every candidate once; the callables are reused across
    rungs (with ``replay``, a card: each a CUDA graph's replay of one call,
    :func:`_replayable`). All-fail raises instead of letting a caller
    persist the defaults as a measured winner."""
    pool: List[Tuple[Dict[str, Any], Callable]] = []
    for params in candidates:
        stats.considered += 1
        try:
            fn = build(params)
            _block(fn())                     # build + warm
            if replay is not None:
                fn = _replayable(fn, replay)
        except Exception as e:               # does not fit, failed build ...
            stats.record_skip(e)
            continue
        stats.builds += 1
        pool.append((dict(params), fn))
    if not pool:
        raise AutotuneError(
            f"autotune({op!r}, bucket {shape_bucket(shape, dtype)!r}): all "
            f"{stats.considered} candidates failed to build/run "
            f"(skipped by exception type: {stats.skipped}); refusing to "
            "persist the built-in defaults as a measured winner")
    return pool


def autotune(op: str, shape: Iterable[int],
             candidates: Iterable[Dict[str, Any]],
             build: Callable[[Dict[str, Any]], Callable[[], Any]],
             iters: int = 3, persist: bool = True, dtype=None,
             timer: Optional[Callable[[], float]] = None,
             stats: Optional[TuneStats] = None, device=None,
             confirm: int = 0) -> Dict[str, Any]:
    """Exhaustive sweep: every candidate timed at ``iters`` (the measured
    search's baseline). Candidates that raise are skipped and recorded in
    ``stats.skipped``; if all raise, :class:`AutotuneError` and nothing is
    persisted. ``dtype`` routes the winner into the dtype-tagged bucket,
    ``device`` names the device kind it persists under and the clock
    (:func:`_time_callable`); ``confirm`` rounds of turns hold a winner
    that is not the default against it (:func:`_hold_against_default`)."""
    stats = stats if stats is not None else TuneStats()
    c0, skip0 = stats.considered, dict(stats.skipped)
    pool = _build_pool(op, shape, dtype, candidates, build, stats,
                       _graph_device(timer, device))
    stats.exhaustive_runs += len(pool) * iters
    best, best_t = None, float("inf")
    for params, fn in pool:
        try:
            t = _time_callable(fn, iters=iters, timer=timer, warm=False,
                               stats=stats, device=device)
        except Exception as e:
            stats.record_skip(e)
            continue
        if t < best_t:
            best, best_t = params, t
    stats.rounds += 1
    if best is None:
        raise AutotuneError(
            f"autotune({op!r}): every candidate raised during timing "
            f"(skipped: {stats.skipped}); not persisting")
    best, best_t, verdict = _hold_against_default(
        op, best, best_t, pool, confirm, iters, timer, device, stats)
    if persist:
        considered, skipped = _stats_delta(stats, c0, skip0)
        _persist_winner(op, shape, dtype, best,
                        _provenance(best_t, iters, considered, skipped,
                                    "exhaustive", device, verdict), device)
    return best


def measured_search(op: str, shape: Iterable[int],
                    candidates: Iterable[Dict[str, Any]],
                    build: Callable[[Dict[str, Any]], Callable[[], Any]],
                    iters: int = 3, start_iters: int = 1, eta: int = 3,
                    persist: bool = True, dtype=None,
                    timer: Optional[Callable[[], float]] = None,
                    stats: Optional[TuneStats] = None,
                    device=None, confirm: int = 0) -> Dict[str, Any]:
    """Successive-halving search over ``candidates``: rung 0 times them all
    at ``start_iters``; each later rung keeps the fastest ``1/eta`` of the
    survivors (at least one) at ``eta`` times the iterations, capped at
    ``iters``, and the search stops at the first rung timed at the cap or
    with one survivor. Ties go to the earlier candidate (a stable sort, as
    :func:`autotune`'s strict ``<``). Failures during timing are recorded;
    an all-fail population raises :class:`AutotuneError` and persists
    nothing. ``timer``, ``device`` and ``confirm`` as :func:`autotune`'s."""
    if iters < 1 or start_iters < 1 or eta < 2:
        raise ValueError(f"need iters/start_iters >= 1 and eta >= 2, got "
                         f"iters={iters} start_iters={start_iters} eta={eta}")
    stats = stats if stats is not None else TuneStats()
    c0, skip0 = stats.considered, dict(stats.skipped)
    pool = _build_pool(op, shape, dtype, candidates, build, stats,
                       _graph_device(timer, device))
    everyone = list(pool)
    stats.exhaustive_runs += len(pool) * iters
    it = min(start_iters, iters)
    best, best_t = None, float("inf")
    while True:
        scored: List[Tuple[float, Dict[str, Any], Callable]] = []
        for params, fn in pool:
            try:
                t = _time_callable(fn, iters=it, timer=timer, warm=False,
                                   stats=stats, device=device)
            except Exception as e:
                stats.record_skip(e)
                continue
            scored.append((t, params, fn))
        stats.rounds += 1
        if not scored:
            raise AutotuneError(
                f"measured_search({op!r}): every surviving candidate raised "
                f"during timing (skipped: {stats.skipped}); not persisting")
        scored.sort(key=lambda s: s[0])      # stable: ties keep seed order
        best_t, best = scored[0][0], scored[0][1]
        if it >= iters or len(scored) == 1:
            break
        keep = max(1, len(scored) // eta)
        pool = [(p, f) for _, p, f in scored[:keep]]
        if len(pool) == 1:                   # decided: skip the re-measure
            break
        it = min(iters, it * eta)
    best, best_t, verdict = _hold_against_default(
        op, best, best_t, everyone, confirm, iters, timer, device, stats)
    if persist:
        considered, skipped = _stats_delta(stats, c0, skip0)
        _persist_winner(op, shape, dtype, best,
                        _provenance(best_t, it, considered, skipped,
                                    "successive_halving", device, verdict),
                        device)
    return best


def _tune(method: str):
    """``"search"`` (the measured search) or ``"exhaustive"`` (the full
    sweep, its baseline)."""
    if method == "search":
        return measured_search
    if method == "exhaustive":
        return autotune
    raise ValueError(f"method must be 'search' or 'exhaustive', "
                     f"got {method!r}")


# ---------------------------------------------------------------------------
# The sweeps: the port's candidates at the serving shapes
# ---------------------------------------------------------------------------

def fused_candidates(grid_orders: Tuple[str, ...] = ()) -> List[Dict[str, Any]]:
    """Every (tile, blocks_per_sm) of the tiled passes, defaults first, and
    each with every grid order given."""
    out = [{"tile": t, "blocks_per_sm": b} for t in KNOBS["tile"]
           for b in KNOBS["blocks_per_sm"]]
    if grid_orders:
        out = [dict(c, grid_order=o) for c in out for o in grid_orders]
    return out


def _serving_cfg():
    from repro_torch.core import DehazeConfig
    return DehazeConfig()


def _serving_kw() -> Dict[str, Any]:
    """The serving configuration's constants (``DehazeConfig()``'s)."""
    cfg = _serving_cfg()
    return dict(radius=cfg.patch_radius, omega=cfg.omega, beta=cfg.beta,
                refine=cfg.refine, gf_radius=cfg.gf_radius, gf_eps=cfg.gf_eps)


def _serving_halo() -> int:
    """The halo a side of the serving configuration's spatial shards."""
    cfg = _serving_cfg()
    return cfg.patch_radius + 2 * cfg.gf_radius


def _resolve_device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _frames(shape, io_dtype: str, device, seed: int = 0) -> torch.Tensor:
    from repro_torch.kernels import ref
    r = np.random.default_rng(seed)
    return ref.quantize_frames(r.random(tuple(shape) + (3,), np.float32),
                               io_dtype).to(device)


def _check_fits(s, fits: Callable) -> None:
    """Raise :class:`TileDoesNotFit` where ``fits(s)`` says no."""
    if not fits(s):
        raise TileDoesNotFit(f"tile {s.tile}: a tiled pass's halo does not fit "
                             f"a block")


def _megakernel_fits(device: torch.device) -> Callable:
    """The library's fits test on the card, its mirror elsewhere (the
    plain version runs there whatever fits)."""
    return _fused.tiled_fits if device.type == "cuda" else _fused.tiled_smem_fits


def _fused_build(shape, io_dtype: str, algorithm: str, topk: int,
                 dev: torch.device) -> Callable:
    """``build(params) -> run`` of ``ops.fused_dehaze`` on (B, H, W)
    frames of ``io_dtype``, the serving configuration."""
    from repro_torch.kernels import ops
    b = shape[0]
    img = _frames(shape, io_dtype, dev)
    ids = torch.arange(b, dtype=torch.int32, device=dev)
    A = torch.ones(3, device=dev)
    k0 = torch.tensor(-(2 ** 30), dtype=torch.int32, device=dev)
    init = torch.tensor(False, device=dev)
    fkw = dict(_serving_kw(), algorithm=algorithm, t0=0.1, gamma=1.0,
               period=8, lam=0.05, topk=topk)

    def build(params):
        _check_fits(_fused.make_static(img[None], **fkw, **params),
                    _megakernel_fits(dev))
        return lambda: ops.fused_dehaze(img, ids, A, k0, init, mode="fused",
                                        **fkw, **params)
    return build


def _lanes_build(shape, io_dtype: str, dev: torch.device) -> Callable:
    """``build(params) -> run`` of ``ops.fused_dehaze_lanes`` on (L, B, H,
    W) frames of ``io_dtype`` (DCP top-1, the serving configuration, the
    last lane all padding as on a partly occupied tick)."""
    from repro_torch.kernels import ops
    n_lanes, b = shape[:2]
    kw = dict(_serving_kw(), algorithm="dcp", t0=0.1, gamma=1.0, period=8,
              lam=0.05)
    img = _frames(shape, io_dtype, dev)
    ids = torch.arange(b, dtype=torch.int32, device=dev).repeat(n_lanes, 1)
    ids[-1] = -1
    carry_f = torch.ones(n_lanes, 3, device=dev)
    carry_i = torch.tensor([[-(2 ** 30), 0]] * n_lanes, dtype=torch.int32,
                           device=dev)

    def build(params):
        knobs = dict(params)
        lane_major = knobs.pop("grid_order") == "lane_major"
        _check_fits(_fused.make_static(img, **kw, **knobs, lane_major=lane_major),
                    _megakernel_fits(dev))
        return lambda: ops.fused_dehaze_lanes(img, ids, carry_f, carry_i,
                                              mode="fused", **kw, **params)
    return build


def _halo_build(shape, halo: int, io_dtype: str, dev: torch.device) -> Callable:
    """``build(params) -> run`` of ``ops.fused_transmission_halo`` on the
    corner tile of a 2 x 2 spatial tiling: (N, h, w) core frames, float32
    pre-map and luma planes extended by ``halo`` a side, the rows and
    columns before the core invalid (the frame's edge), the others valid
    (the neighbours'); the serving configuration."""
    from repro_torch.kernels import ops
    n, h, w = shape
    kw = dict(_serving_kw(), algorithm="dcp")
    img = _frames(shape, io_dtype, dev)
    r = np.random.default_rng(1)
    ext = (n, h + 2 * halo, w + 2 * halo)
    pre = torch.from_numpy(r.random(ext, np.float32)).to(dev)
    guide = torch.from_numpy(r.random(ext, np.float32)).to(dev)
    valid = torch.arange(ext[1], device=dev) >= halo
    valid_w = torch.arange(ext[2], device=dev) >= halo

    def build(params):
        _check_fits(_fused.make_halo_static(img, pre, guide, **kw, **params),
                    _fused.halo_tiled_fits)
        return lambda: ops.fused_transmission_halo(
            img, pre, guide, valid, valid_w, mode="fused", **kw, **params)
    return build


def _atmo_build(shape, k: int, dev: torch.device) -> Callable:
    """``build(params) -> run`` of ``ops.atmospheric_light`` over float32
    (N, H, W) frames and t, as the staged step hands them over."""
    from repro_torch.kernels import ops
    r = np.random.default_rng(2)
    img = torch.from_numpy(r.random(tuple(shape) + (3,), np.float32)).to(dev)
    t = torch.from_numpy(r.random(tuple(shape), np.float32)).to(dev)

    def build(params):
        return lambda: ops.atmospheric_light(img, t, k, mode="pallas", **params)
    return build


#: The top-k a ``_topk`` op is timed at where no sweep names one (the
#: serving configurations' k > 1).
TOPK = 4


def parse_bucket(bucket: str) -> Tuple[Tuple[int, ...], str]:
    """A bucket key's shape and wire dtype name (``float32`` untagged)."""
    parts = bucket.split("x")
    tags = {v: k for k, v in _DTYPE_TAGS.items()}
    io_dtype = tags.get(parts[-1], "float32")
    if parts[-1] in tags:
        parts = parts[:-1]
    return tuple(int(p) for p in parts), io_dtype


def _builder(op: str, shape, io_dtype: str, dev: torch.device) -> Callable:
    """``build(params) -> run`` of ``op`` at ``shape`` as its sweep times
    it (a ``_topk`` op at k = :data:`TOPK`, the halo stage at the serving
    halo)."""
    if op == "fused_lanes":
        return _lanes_build(shape, io_dtype, dev)
    if op == "fused_halo_2d":
        return _halo_build(shape, _serving_halo(), io_dtype, dev)
    k = TOPK if op.endswith("_topk") else 1
    if op.startswith("atmolight"):
        return _atmo_build(shape, k, dev)
    if op in DEFAULTS:
        return _fused_build(shape, io_dtype, op.split("_")[1], k, dev)
    raise ValueError(f"unknown tuning op {op!r}")


def against_default(op: str, bucket: str, params: Dict[str, Any],
                    device=None, rounds: int = CONFIRM_ROUNDS,
                    iters: int = 9) -> Dict[str, Any]:
    """A table entry's ``params`` (over the defaults) timed against
    ``DEFAULTS[op]`` at the entry's bucket in ``rounds`` rounds of turns of
    ``iters`` calls on ``device`` (on a card, a graph's replays by its own
    clock): :func:`_verdict`'s medians, spread, ``faster`` and
    ``slower``."""
    dev = _resolve_device(device)
    shape, io_dtype = parse_bucket(bucket)
    build = _builder(op, shape, io_dtype, dev)
    fns = []
    for p in (DEFAULTS[op], params):
        fn = build(check_params(op, dict(DEFAULTS[op], **p)))
        _block(fn())
        fns.append(_replayable(fn, dev) if _on_card(dev) else fn)
    return _verdict(_turns(*fns, rounds, iters, device=dev))


def autotune_fused(shapes=((8, 480, 640),), iters: int = 3,
                   persist: bool = True, algorithms=("dcp",), topks=(1,),
                   io_dtypes=("uint8",), method: str = "search",
                   stats: Optional[TuneStats] = None,
                   device=None) -> Dict[str, Any]:
    """Search the megakernel's tile and blocks an SM per algorithm, per
    A-estimator (``fused_<alg>`` at top-1, ``fused_<alg>_topk`` above) and
    per wire dtype, at (B, H, W) serving shapes, through ``ops.fused_dehaze``
    with the serving configuration."""
    tune, dev = _tune(method), _resolve_device(device)
    table: Dict[str, Any] = {}
    for algorithm in algorithms:
        for topk in topks:
            op = f"fused_{algorithm}" + ("_topk" if topk > 1 else "")
            table.setdefault(op, {})
            for io_dtype in io_dtypes:
                for shape in shapes:
                    table[op][shape_bucket(shape, io_dtype)] = tune(
                        op, shape, fused_candidates(),
                        _fused_build(shape, io_dtype, algorithm, topk, dev),
                        iters=iters, persist=persist, dtype=io_dtype,
                        stats=stats, device=dev, confirm=CONFIRM_ROUNDS)
    return table


def autotune_fused_lanes(shapes=((4, 8, 480, 640),), io_dtype: str = "uint8",
                         orders=_fused.GRID_ORDERS, iters: int = 3,
                         persist: bool = True, method: str = "search",
                         stats: Optional[TuneStats] = None,
                         device=None) -> Dict[str, Any]:
    """Search the lane-native megakernel's tile x blocks an SM x grid order
    per (L, B, H, W) serving shape (:func:`_lanes_build`), into the
    ``fused_lanes`` bucket."""
    tune, dev = _tune(method), _resolve_device(device)
    table: Dict[str, Any] = {"fused_lanes": {}}
    for shape in shapes:
        table["fused_lanes"][shape_bucket(shape, io_dtype)] = tune(
            "fused_lanes", shape, fused_candidates(tuple(orders)),
            _lanes_build(shape, io_dtype, dev), iters=iters, persist=persist,
            dtype=io_dtype, stats=stats, device=dev, confirm=CONFIRM_ROUNDS)
    return table


def autotune_fused_halo(shapes=((32, 240, 320),), halo: Optional[int] = None,
                        io_dtype: str = "uint8", iters: int = 3,
                        persist: bool = True, method: str = "search",
                        stats: Optional[TuneStats] = None,
                        device=None) -> Dict[str, Any]:
    """Search the halo stage's (B9) tile and blocks an SM on the corner
    tile of a 2 x 2 spatial tiling (:func:`_halo_build`; ``halo`` None:
    the serving configuration's), into ``fused_halo_2d``."""
    tune, dev = _tune(method), _resolve_device(device)
    halo = _serving_halo() if halo is None else halo
    table: Dict[str, Any] = {"fused_halo_2d": {}}
    for shape in shapes:
        table["fused_halo_2d"][shape_bucket(shape, io_dtype)] = tune(
            "fused_halo_2d", shape, fused_candidates(),
            _halo_build(shape, halo, io_dtype, dev), iters=iters,
            persist=persist, dtype=io_dtype, stats=stats, device=dev,
            confirm=CONFIRM_ROUNDS)
    return table


def autotune_atmolight(shapes=((32, 480, 640),), ks=(1, TOPK), iters: int = 3,
                       persist: bool = True, method: str = "search",
                       stats: Optional[TuneStats] = None,
                       device=None) -> Dict[str, Any]:
    """Search B6a's (k = 1, ``atmolight``) and B6b's (k > 1,
    ``atmolight_topk``) tile over float32 (N, H, W) frames and t, as the
    staged step hands them over, through ``ops.atmospheric_light``."""
    tune, dev = _tune(method), _resolve_device(device)
    table: Dict[str, Any] = {}
    for k in ks:
        op = "atmolight_topk" if k > 1 else "atmolight"
        table.setdefault(op, {})
        for shape in shapes:
            table[op][shape_bucket(shape)] = tune(
                op, shape, [{"tile_pixels": p} for p in KNOBS["tile_pixels"]],
                _atmo_build(shape, k, dev), iters=iters, persist=persist,
                stats=stats, device=dev, confirm=CONFIRM_ROUNDS)
    return table


# ---------------------------------------------------------------------------
# CLI: generate and validate per-card tables
# ---------------------------------------------------------------------------

_SMOKE = dict(shapes=((2, 8, 8),), lanes_shapes=((2, 2, 8, 8),),
              halo_shapes=((2, 8, 16),), halo=3, atmo_shapes=((2, 8, 8),),
              iters=2)


def run_search(smoke: bool = False, iters: Optional[int] = None,
               persist: bool = True, method: str = "search",
               device=None) -> Tuple[Dict[str, Any], TuneStats]:
    """Run the four sweeps at the serving shapes (``smoke``: tiny ones);
    returns (the winners, the cost stats)."""
    stats = TuneStats()
    kw: Dict[str, Any] = dict(method=method, persist=persist, stats=stats,
                              device=device)
    if iters is not None:
        kw["iters"] = iters
    if smoke:
        kw.setdefault("iters", _SMOKE["iters"])
        out = autotune_fused(shapes=_SMOKE["shapes"], **kw)
        out.update(autotune_fused_lanes(shapes=_SMOKE["lanes_shapes"], **kw))
        out.update(autotune_fused_halo(shapes=_SMOKE["halo_shapes"],
                                       halo=_SMOKE["halo"], **kw))
        out.update(autotune_atmolight(shapes=_SMOKE["atmo_shapes"], **kw))
    else:
        out = autotune_fused(**kw)
        out.update(autotune_fused_lanes(**kw))
        out.update(autotune_fused_halo(**kw))
        out.update(autotune_atmolight(**kw))
    return out, stats


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.tuning",
        description="Measured-search tuner of the port's kernel knobs: "
                    "persists winners into the device-kind-keyed table")
    ap.add_argument("--search", action="store_true",
                    help="run the successive-halving measured search "
                         "(the default action)")
    ap.add_argument("--exhaustive", action="store_true",
                    help="run the exhaustive sweep instead")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes and 2 iterations; also exits non-zero "
                         "unless the search timed fewer runs than the "
                         "exhaustive candidates x iters")
    ap.add_argument("--iters", type=int, default=None,
                    help="full-fidelity timing iterations (default 3; "
                         "smoke 2)")
    ap.add_argument("--no-persist", action="store_true",
                    help="measure only; do not write the table")
    ap.add_argument("--validate", action="store_true",
                    help="validate the table's schema, provenance and "
                         "knobs and exit")
    ap.add_argument("--require-kind", default=None,
                    help="with --validate: fail unless this device kind "
                         "has measured entries in the table")
    ap.add_argument("--device", default=None,
                    help="the device to tune on (default: the CUDA card; "
                         "'cpu' times the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.validate:
        table = load_table()
        errors = validate_table(table)
        kinds = sorted(table.get("device_kinds", {}))
        if args.require_kind and args.require_kind not in kinds:
            errors.append(f"required device kind {args.require_kind!r} has "
                          f"no measured entries (kinds present: {kinds})")
        print(json.dumps({"path": str(table_path()), "device_kinds": kinds,
                          "errors": errors}, indent=2))
        return 1 if errors else 0

    method = "exhaustive" if args.exhaustive else "search"
    device = _resolve_device(args.device)
    out, stats = run_search(smoke=args.smoke, iters=args.iters,
                            persist=not args.no_persist, method=method,
                            device=device)
    summary = {**out, "path": str(table_path()),
               "device_kind": device_kind(device), "method": method,
               "stats": dataclasses.asdict(stats)}
    print(json.dumps(summary, indent=2))
    if args.smoke and method == "search" \
            and stats.timed_runs >= stats.exhaustive_runs:
        print(f"FAIL: measured search timed {stats.timed_runs} runs, not "
              f"fewer than the exhaustive product {stats.exhaustive_runs}")
        return 1
    return 0


__all__ = ["DEFAULTS", "KNOBS", "SCHEMA_VERSION", "AutotuneError",
           "TileDoesNotFit", "table_path", "device_kind", "shape_bucket",
           "load_table", "save_table", "migrate_table", "get_params",
           "check_params", "resolve", "state_token", "validate_table",
           "TuneStats", "CONFIRM_ROUNDS", "TOPK", "autotune",
           "measured_search", "fused_candidates", "parse_bucket",
           "against_default",
           "autotune_fused", "autotune_fused_lanes", "autotune_fused_halo",
           "autotune_atmolight", "run_search", "main"]


if __name__ == "__main__":
    raise SystemExit(main())
