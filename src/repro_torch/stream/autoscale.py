"""Elastic lane autoscaling: a ladder of warmed lane counts with
hysteresis (paper §5: the cluster "scales with the actual workload").

The unit of scale of the lane-batched serving runtime is the lane count L
of its ``(L, B, H, W, 3)`` batch. A small *ladder* of lane counts is
built through the bounded step cache; the scheduler walks it from the
pending-queue depth and the lane occupancy, and every rung but the first
is warmed on a background thread, so a switch on the serve thread is a
dictionary lookup.

Warming a rung is one call of its step (or of its ``stream.iobuf.
LaneTickStep`` adapter, on the overlapped path) on an all-padding batch
(``frame_id = -1`` everywhere, an identity for the masked EMA) of zeros
made on the device: the call builds the kernels if they are not built yet
(an ``nvcc`` run at the first use of a source), launches them at the new
L and binds the adapter's device buffer, and the frames cross no copy. On
CUDA each warm-up runs on a stream of its own, and the rung is offered
only after that stream has finished, so the serve thread's first stage
into the rung's buffer cannot race the warm-up still reading it.

Hysteresis, with distinct conditions and dwell counts:

  * grow   — every lane occupied and >= ``grow_pending`` streams queued,
             ``dwell_up`` ticks in a row;
  * shrink — no stream queued and the occupancy fits the next rung down,
             ``dwell_down`` ticks in a row.

A load that satisfies neither holds the rung. A target rung not warm yet
defers the switch (the streak persists), which lands on the first tick
the rung is ready. A rung whose warm-up raises is retried once, when the
ladder first wants it; after :data:`WARM_MAX_ATTEMPTS` failures it is
never offered and counts in :attr:`LaneAutoscaler.warm_failures`, which
rides on ``ServeReport.warm_failures``: nothing carries on at a fixed lane
count without saying so.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.normalize import init_atmo_state_lanes
from repro_torch.core.pipeline import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_RUNGS = (4, 8, 16, 32)

# A rung's warm-up is retried at most once: a transient failure gets a
# second chance, a rung that cannot be built stops costing warm-up time.
WARM_MAX_ATTEMPTS = 2


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Ladder, hysteresis and eviction knobs of ``serve_many``.

    ``rungs`` is the lane-count ladder (capped by the serve call's
    ``n_lanes``, :func:`ladder_rungs`). ``evict_tardy_after``: a stream
    past its deadline that has held a lane for that many ticks while
    others queue is checkpointed and requeued as deadline-less; ``None``
    disables eviction."""
    rungs: Tuple[int, ...] = DEFAULT_RUNGS
    grow_pending: int = 1       # queued streams that count as load
    dwell_up: int = 2           # ticks of load in a row before growing
    dwell_down: int = 4         # ticks of slack in a row before shrinking
    evict_tardy_after: Optional[int] = 8


def ladder_rungs(rungs: Sequence[int], max_lanes: int) -> Tuple[int, ...]:
    """The ladder served: every rung below ``max_lanes`` and ``max_lanes``
    itself (the cap is always reachable; a cap below the smallest rung is
    a one-rung ladder)."""
    if max_lanes < 1:
        raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
    kept = sorted({int(r) for r in rungs if 0 < r < max_lanes})
    return tuple(kept) + (max_lanes,)


class LaneAutoscaler:
    """Walks a ladder of warmed lane counts for the scheduler.

    ``step_factory(n_lanes)`` returns a rung's lane step (the bounded step
    cache of ``stream.elastic``, or a ``TickBufferPool``'s adapters on the
    overlapped path). The scheduler calls :meth:`observe` once a tick with
    the queue depth and the occupancy; a rung it returns is warm, so
    :meth:`step_for` is a lookup. :meth:`commit` records the switch and
    resets the streaks. ``device`` is where warm-up batches are made
    (``None``: CUDA); ``state_factory(n)`` makes a warm-up state.
    """

    def __init__(self, step_factory: Callable[[int], Callable],
                 rungs: Sequence[int],
                 policy: ScalePolicy = ScalePolicy(),
                 state_factory: Optional[Callable[[int], Any]] = None,
                 device: DeviceLike = None):
        if not rungs:
            raise ValueError("autoscale ladder must have at least one rung")
        self.rungs = tuple(sorted(set(int(r) for r in rungs)))
        if self.rungs[0] < 1:
            raise ValueError(f"lane rungs must be >= 1, got {self.rungs}")
        self.policy = policy
        self.device = resolve_device(device)
        self._step_factory = step_factory
        self._state_factory = state_factory or (
            lambda n: init_atmo_state_lanes(n, self.device))
        self._idx = 0
        self._steps: Dict[int, Callable] = {}
        self._ready: set = set()
        self._lock = threading.Lock()
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_errors: Dict[int, Exception] = {}
        self._warm_attempts: Dict[int, int] = {}
        # Rungs with a warm-up running: never two at once for one rung
        # (an adapter's buffer belongs to one caller at a time).
        self._warming: set = set()
        self._warm_shape: Optional[Tuple[Tuple[int, ...], Any]] = None
        self._retry_threads: List[threading.Thread] = []
        self._up = 0
        self._down = 0
        # One record per committed switch: {"from", "to", "wall_s"}.
        self.switches: List[Dict[str, Any]] = []
        # One record per warm-up call that returned: {"rung", "thread"
        # (its ident), "s" (seconds, the device's work included)}.
        self.warm_log: List[Dict[str, Any]] = []

    # -- rungs -------------------------------------------------------------

    @property
    def rung(self) -> int:
        """The active lane count."""
        return self.rungs[self._idx]

    def acquire_initial(self) -> Callable:
        """The starting rung's step, built on the caller's thread (serve
        start-up, not a switch)."""
        step = self._step_factory(self.rung)
        with self._lock:
            self._steps[self.rung] = step
            self._ready.add(self.rung)
        return step

    def step_for(self, rung: int) -> Callable:
        """A warm rung's step (``KeyError`` for a rung not warm:
        :meth:`observe` never offers one)."""
        with self._lock:
            return self._steps[rung]

    def is_ready(self, rung: int) -> bool:
        with self._lock:
            return rung in self._ready

    # -- warming -----------------------------------------------------------

    def ensure_warming(self, lane_batch_shape: Tuple[int, ...],
                       dtype: torch.dtype = torch.float32) -> None:
        """Start (once) the thread that warms every other rung, at the
        per-lane ``(B, H, W, 3)`` batch shape and wire ``dtype`` the serve
        feeds (known at its first tick)."""
        with self._lock:
            if self._warm_thread is not None:
                return
            self._warm_shape = (tuple(lane_batch_shape), dtype)
            todo = [r for r in self.rungs if r not in self._ready]
            self._warm_thread = threading.Thread(
                target=self._warm, args=(self._warm_shape, todo),
                daemon=True, name="lane-ladder-warm")
        self._warm_thread.start()

    def _warm_call(self, step: Callable, rung: int,
                   shape: Tuple[Tuple[int, ...], Any]) -> None:
        (b, h, w, c), dtype = shape
        dev = self.device
        frames = torch.zeros((rung, b, h, w, c), dtype=dtype, device=dev)
        ids = torch.full((rung, b), -1, dtype=torch.int32, device=dev)
        step(frames, ids, self._state_factory(rung))

    def _warm(self, shape, todo: Sequence[int]) -> None:
        for rung in todo:
            with self._lock:
                if rung in self._warming or rung in self._ready:
                    continue
                self._warming.add(rung)
                self._warm_attempts[rung] = \
                    self._warm_attempts.get(rung, 0) + 1
            try:
                t0 = time.perf_counter()
                step = self._step_factory(rung)
                if self.device.type == "cuda":
                    stream = torch.cuda.Stream(self.device)
                    with torch.cuda.stream(stream):
                        self._warm_call(step, rung, shape)
                    stream.synchronize()
                else:
                    self._warm_call(step, rung, shape)
                with self._lock:
                    self.warm_log.append({
                        "rung": rung, "thread": threading.get_ident(),
                        "s": time.perf_counter() - t0})
                    self._steps[rung] = step
                    self._ready.add(rung)
                    self._warm_errors.pop(rung, None)
            except Exception as e:
                with self._lock:
                    self._warm_errors[rung] = e
                    attempt = self._warm_attempts[rung]
                logger.warning(
                    "lane-ladder warm-up failed for rung %d (attempt %d/%d):"
                    " %s: %s", rung, attempt, WARM_MAX_ATTEMPTS,
                    type(e).__name__, e)
            finally:
                with self._lock:
                    self._warming.discard(rung)

    def _retry_warm(self, rung: int) -> None:
        """Start one more warm-up of a rung whose warm-up failed (at most
        :data:`WARM_MAX_ATTEMPTS` in all)."""
        with self._lock:
            if self._warm_shape is None \
                    or self._warm_attempts.get(rung, 0) >= WARM_MAX_ATTEMPTS \
                    or rung in self._ready or rung in self._warming:
                return
            th = threading.Thread(target=self._warm,
                                  args=(self._warm_shape, [rung]),
                                  daemon=True, name=f"lane-warm-retry-{rung}")
            self._retry_threads.append(th)
        th.start()

    @property
    def warm_errors(self) -> Dict[int, Exception]:
        """Rung -> the exception of its latest warm-up attempt (a rung
        that later warmed is removed)."""
        with self._lock:
            return dict(self._warm_errors)

    @property
    def warm_failures(self) -> int:
        """Rungs whose latest warm-up failed, and that are not offered."""
        with self._lock:
            return len(self._warm_errors)

    def wait_warm(self, timeout: Optional[float] = None,
                  raise_on_error: bool = False) -> bool:
        """Wait for the warm-up and retry threads; ``True`` when none is
        left running. ``raise_on_error`` raises ``RuntimeError`` (chained
        to the first rung's exception) when a rung's warm-up failed."""
        th = self._warm_thread
        done = True
        if th is not None:
            th.join(timeout=timeout)
            done = not th.is_alive()
        with self._lock:
            retries = list(self._retry_threads)
        for th in retries:
            th.join(timeout=timeout)
            done = done and not th.is_alive()
        if raise_on_error:
            errs = self.warm_errors
            if errs:
                rung = min(errs)
                raise RuntimeError(
                    f"lane-ladder warm-up failed for rung(s) "
                    f"{sorted(errs)}: {type(errs[rung]).__name__}: "
                    f"{errs[rung]}") from errs[rung]
        return done

    # -- the ladder walk ---------------------------------------------------

    def observe(self, pending: int, occupied: int) -> Optional[int]:
        """One tick's load -> a warm rung to switch to, or ``None``. A
        tick that breaks a streak resets its count."""
        p = self.policy
        cur = self.rung
        grow = (self._idx + 1 < len(self.rungs)
                and pending >= p.grow_pending and occupied >= cur)
        shrink = (self._idx > 0 and pending == 0
                  and occupied <= self.rungs[self._idx - 1])
        self._up = self._up + 1 if grow else 0
        self._down = self._down + 1 if shrink else 0
        if self._up >= p.dwell_up:
            target = self.rungs[self._idx + 1]
            if self.is_ready(target):
                return target
            self._retry_warm(target)         # nothing unless it failed
        if self._down >= p.dwell_down:
            target = self.rungs[self._idx - 1]
            if self.is_ready(target):
                return target
            self._retry_warm(target)
        return None

    def commit(self, rung: int, wall_s: float = 0.0) -> None:
        """Record a completed switch and reset the streaks."""
        prev = self.rung
        self._idx = self.rungs.index(rung)
        self._up = 0
        self._down = 0
        self.switches.append({"from": prev, "to": rung, "wall_s": wall_s})


__all__ = ["ScalePolicy", "LaneAutoscaler", "ladder_rungs", "DEFAULT_RUNGS",
           "WARM_MAX_ATTEMPTS"]
