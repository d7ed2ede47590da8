"""Multi-tenant lane scheduler: continuous batching across video streams.

N live videos are multiplexed onto L *lanes* of one fixed-shape
``(L, B, H, W, 3)`` batch, stepped by the lane-batched step
(``core.pipeline.make_multi_stream_step``: the lane-native megakernel on
fused configs, the staged component kernels over all lanes otherwise).
Per lane:

  layer 1 (spout)        — one ``Spout`` per admitted stream assigns ids
                           from that stream's restart-safe cursor;
  layers 2-4 (components)— all lanes share one step call per tick; each
                           lane's §3.3 EMA state is one row of the
                           lane-batched ``AtmoState``;
  layer 5 (monitor)      — one ``Monitor`` per stream restores its order.

A stream is admitted into the first free lane the moment one is free, in
``(priority, deadline, arrival)`` order; an exhausted stream is evicted at
the tick it ends (state + cursor written back to the store) and its lane
is reused in the same tick. Unoccupied lanes carry ``frame_id = -1``
padding, which the masked EMA treats as identity.

Two tick paths (README, "Tick I/O & overlap"). The blocking path, the
parity oracle, stacks the lanes on the host, steps the whole batch, and
fetches the whole of ``out.frames``, padding included, on the compute
stream. The overlapped path (a step with ``stage``/``tick``,
``stream.iobuf.LaneTickStep``) uploads only live lanes into a
device-resident buffer before it waits for the in-flight window, runs the
state-donated step on it, and fetches only the valid frames of live lanes
on a side stream.

This port serves at a fixed lane count: the reference's ``autoscaler=``
and ``evict_tardy_after=`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.normalize import (AtmoState, get_lane_state,
                                        init_atmo_state_lanes, set_lane_state)
from repro_torch.stream.iobuf import is_overlap_step
from repro_torch.stream.monitor import DEADLINE_CLOCK, Monitor
from repro_torch.stream.spout import FrameBatch, Spout
from repro_torch.stream.state import StreamStateStore


@dataclasses.dataclass
class StreamRequest:
    """One stream to serve: id, iterable of ``(H, W, 3)`` frames, optional
    ``deadline`` (on the scheduler's clock, :data:`DEADLINE_CLOCK` by
    default) and ``priority`` (lower admits first, default 0)."""
    stream_id: str
    frames: Iterable
    deadline: Optional[float] = None
    priority: Optional[int] = None

    def admission_key(self, arrival: int) -> Tuple[float, float, int]:
        prio = 0 if self.priority is None else self.priority
        deadline = math.inf if self.deadline is None else self.deadline
        return (prio, deadline, arrival)


# sink(stream_id, frame_id, frame) — called in per-stream ascending order.
MultiSink = Callable[[str, int, torch.Tensor], None]


@dataclasses.dataclass
class StreamReport:
    """Per-stream serving outcome (one row of ``ServeReport.per_stream``)."""
    stream_id: str
    frames: int
    skipped: int
    wall_s: float

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass
class ServeReport:
    """Serving outcome of ``serve`` (one lane) and ``serve_many``."""
    per_stream: Dict[str, StreamReport]
    frames: int          # total real frames stepped, all streams
    skipped: int         # total monitor skips, all streams
    wall_s: float
    n_lanes: int
    ticks: int           # step calls issued
    admissions: int = 0
    # Ticks that took the zero-copy overlapped path; a serve that expects
    # overlap treats overlap_ticks < ticks as a failure
    # (launch/serve.py --expect-overlap).
    overlap_ticks: int = 0
    stragglers: int = 0  # completion threads still alive at shutdown
    # Bytes copied device -> host by completions: valid-only slices on the
    # overlapped path, whole batches (padding included) on the blocking
    # path of serve_many, valid-only on serve's.
    d2h_bytes: int = 0
    # Serve-loop seconds by phase: "host_stage_s" (lane uploads or batch
    # assembly), "device_step_s" (step dispatch), "deliver_s" (completions'
    # D2H and monitor delivery, summed over their threads).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def fps(self) -> float:
        """Throughput: total frames across streams per wall second."""
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    # The fleet-level name of the same number.
    aggregate_fps = fps


class _Lane:
    """Host-side bookkeeping for one occupied lane."""
    __slots__ = ("request", "it", "monitor", "mon_thread", "start",
                 "frames_done", "admitted_at")

    def __init__(self, request: StreamRequest, it, monitor: Monitor,
                 mon_thread: threading.Thread, start: int,
                 admitted_at: float):
        self.request = request
        self.it = it
        self.monitor = monitor
        self.mon_thread = mon_thread
        self.start = start
        self.frames_done = 0
        self.admitted_at = admitted_at

    @property
    def stream_id(self) -> str:
        return self.request.stream_id


class MultiStreamScheduler:
    """Drives ``step(frames (L,B,H,W,3), ids (L,B), state) -> DehazeOutput``
    over many live streams with lane admission, eviction and reuse."""

    def __init__(self, step: Callable, store: StreamStateStore,
                 n_lanes: int, batch: int = 8, timeout_s: float = 0.020,
                 max_in_flight: int = 4, autoscaler=None,
                 evict_tardy_after: Optional[int] = None,
                 clock: Callable[[], float] = DEADLINE_CLOCK,
                 shutdown_timeout_s: float = 30.0):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if autoscaler is not None:
            raise NotImplementedError(
                "elastic lane autoscaling is not ported yet (ROADMAP.md "
                "queue A, autoscale)")
        if evict_tardy_after is not None:
            raise NotImplementedError(
                "deadline-aware eviction is not ported yet (ROADMAP.md "
                "queue A, eviction)")
        self._step = step
        self.store = store
        self.n_lanes = n_lanes
        self.batch = batch
        self.timeout_s = timeout_s
        self._sem = threading.Semaphore(max_in_flight)
        self._clock = clock
        self._shutdown_timeout_s = shutdown_timeout_s

    # -- lane lifecycle ----------------------------------------------------

    def _admit(self, lane_idx: int, req: StreamRequest, packed: AtmoState,
               sink: Optional[MultiSink]) -> AtmoState:
        sid = req.stream_id
        start, state = self.store.cursor(sid), self.store.get(sid)

        def write(fid: int, payload: torch.Tensor) -> None:
            if sink is not None:
                sink(sid, fid, payload)

        monitor = Monitor(write, timeout_s=self.timeout_s, start_frame=start,
                          clock=self._clock)
        mon_thread = threading.Thread(target=monitor.run, daemon=True)
        mon_thread.start()
        spout = Spout(req.frames, batch=self.batch, start_frame=start,
                      stream_id=sid)
        self._lanes[lane_idx] = _Lane(req, iter(spout), monitor, mon_thread,
                                      start, time.perf_counter())
        self._admissions += 1
        return set_lane_state(packed, lane_idx, state)

    def _evict(self, lane_idx: int, packed: AtmoState) -> None:
        """Free the lane now; finalize in the background (wait for the
        in-flight completions that may still hold this stream's frames,
        drain its monitor, persist state + cursor)."""
        lane = self._lanes[lane_idx]
        self._lanes[lane_idx] = None
        final_state = get_lane_state(packed, lane_idx)
        cursor = lane.start + lane.frames_done
        waits = list(self._inflight)
        wall_s = time.perf_counter() - lane.admitted_at

        def finalize() -> None:
            for th in waits:
                th.join()
            lane.monitor.close()
            lane.mon_thread.join(timeout=5.0)
            lane.monitor.drain()
            self.store.update(lane.stream_id, final_state, cursor)
            with self._report_lock:
                self._reports[lane.stream_id] = StreamReport(
                    stream_id=lane.stream_id, frames=lane.frames_done,
                    skipped=lane.monitor.stats.skipped, wall_s=wall_s)

        th = threading.Thread(target=finalize, daemon=True)
        th.start()
        self._finalizers.append(th)

    def _fill_lane(self, lane_idx: int, packed: AtmoState,
                   sink: Optional[MultiSink]
                   ) -> Tuple[Optional[FrameBatch], AtmoState]:
        """Next batch for a lane: an exhausted stream is evicted and the
        lane immediately reused by the next pending stream."""
        while True:
            if self._lanes[lane_idx] is None:
                if not self._pending:
                    return None, packed
                _, req = heapq.heappop(self._pending)
                packed = self._admit(lane_idx, req, packed, sink)
                self._packed = packed
            fb = next(self._lanes[lane_idx].it, None)
            if fb is not None:
                return fb, packed
            self._evict(lane_idx, packed)

    # -- the serve loop ----------------------------------------------------

    def run(self, streams: Iterable[StreamRequest],
            sink: Optional[MultiSink] = None) -> ServeReport:
        requests = list(streams)
        for r in requests:
            if not isinstance(r, StreamRequest):
                raise TypeError(f"expected StreamRequest, got "
                                f"{type(r).__name__}")
        sids = [r.stream_id for r in requests]
        if len(set(sids)) != len(sids):
            dupes = sorted({s for s in sids if sids.count(s) > 1})
            raise ValueError(f"duplicate stream ids in one serve_many call: "
                             f"{dupes}")
        # Heap entries (key, request): keys are unique (arrival breaks ties).
        self._pending = []
        for arrival, req in enumerate(requests):
            heapq.heappush(self._pending, (req.admission_key(arrival), req))
        self._lanes: List[Optional[_Lane]] = [None] * self.n_lanes
        self._inflight: List[threading.Thread] = []
        self._finalizers: List[threading.Thread] = []
        self._reports: Dict[str, StreamReport] = {}
        self._report_lock = threading.Lock()
        self._admissions = 0
        self._overlap_ticks = 0
        self._stragglers = 0
        self._d2h_bytes = 0
        self._phases: Dict[str, float] = {
            "host_stage_s": 0.0, "device_step_s": 0.0, "deliver_s": 0.0}
        self._packed = init_atmo_state_lanes(self.n_lanes)
        ticks = 0
        t0 = time.perf_counter()
        try:
            ticks = self._tick_loop(sink)
        finally:
            # Normal exit or mid-serve error: evict every live lane so the
            # served streams flush and persist, then wait (bounded) for
            # every completion and finalizer thread.
            for i in range(len(self._lanes)):
                if self._lanes[i] is not None:
                    self._evict(i, self._packed)
            deadline = time.perf_counter() + self._shutdown_timeout_s
            for th in self._inflight + self._finalizers:
                th.join(timeout=max(0.0, deadline - time.perf_counter()))
                if th.is_alive():
                    self._stragglers += 1
        wall = time.perf_counter() - t0
        reports = self._reports
        return ServeReport(
            per_stream=reports,
            frames=sum(r.frames for r in reports.values()),
            skipped=sum(r.skipped for r in reports.values()),
            wall_s=wall, n_lanes=self.n_lanes, ticks=ticks,
            admissions=self._admissions, overlap_ticks=self._overlap_ticks,
            stragglers=self._stragglers, d2h_bytes=self._d2h_bytes,
            phases=dict(self._phases))

    def _tick_loop(self, sink: Optional[MultiSink]) -> int:
        ticks = 0
        packed = self._packed
        pad_frames: Optional[torch.Tensor] = None
        pad_ids = torch.full((self.batch,), -1, dtype=torch.int32)
        while True:
            fbs: List[Optional[FrameBatch]] = []
            for i in range(len(self._lanes)):
                fb, packed = self._fill_lane(i, packed, sink)
                self._packed = packed
                fbs.append(fb)
            live = [fb for fb in fbs if fb is not None]
            if not live:
                break
            if pad_frames is None:
                pad_frames = torch.zeros_like(live[0].frames)
            for fb in live:
                if fb.frames.shape != pad_frames.shape \
                        or fb.frames.dtype != pad_frames.dtype:
                    raise ValueError(
                        f"stream {fb.stream_id!r} batch {tuple(fb.frames.shape)}"
                        f" {fb.frames.dtype} != lane batch "
                        f"{tuple(pad_frames.shape)} {pad_frames.dtype}; all "
                        "multiplexed streams share (H, W), dtype and batch")

            overlap = is_overlap_step(self._step)
            t_stage = self._clock()
            if overlap:
                # Upload only the live lanes into the device buffer (padding
                # lanes keep stale rows: id-masked, never fetched). The
                # copies run on the upload stream and the splices queue on
                # the compute stream, so this overlaps the tick in flight,
                # which is why it comes before the window's acquire.
                for i, fb in enumerate(fbs):
                    if fb is not None:
                        self._step.stage(i, fb.frames)
            else:
                frames = torch.stack([fb.frames if fb is not None
                                      else pad_frames for fb in fbs])
            ids = torch.stack([fb.frame_ids if fb is not None else pad_ids
                               for fb in fbs])
            self._phases["host_stage_s"] += self._clock() - t_stage
            metas = [(i, self._lanes[i].monitor, fb.frame_ids, fb.n_valid)
                     for i, fb in enumerate(fbs) if fb is not None]
            for i, fb in enumerate(fbs):
                if fb is not None:
                    self._lanes[i].frames_done += fb.n_valid

            self._sem.acquire()
            t_step = self._clock()
            if overlap:
                # The state is donated into this tick: every read of
                # `packed` (eviction snapshots, admissions) was enqueued
                # on the compute stream before it.
                out = self._step.tick(ids, packed)
                done = self._step.copies.tick_done()
                self._overlap_ticks += 1
            else:
                out = self._step(frames, ids, packed)
                done = None
            packed = out.state                 # on the device, maybe in flight
            self._packed = packed
            self._phases["device_step_s"] += self._clock() - t_step
            th = threading.Thread(target=self._complete,
                                  args=(metas, out, overlap, done),
                                  daemon=True)
            th.start()
            self._inflight.append(th)
            self._inflight = [t for t in self._inflight if t.is_alive()]
            ticks += 1
        return ticks

    def _complete(self, metas, out, overlap: bool, done) -> None:
        """Deliver one tick; ``done`` is the overlapped tick's event."""
        try:
            t0 = self._clock()
            d2h = 0
            if overlap:
                # Valid-only fetches of the live lanes on the fetch stream.
                fetched = self._step.copies.fetch(
                    out.frames, [(m[0], m[3]) for m in metas], done)
                for (_, monitor, frame_ids, n_valid), lane_frames in zip(
                        metas, fetched):
                    d2h += lane_frames.numel() * lane_frames.element_size()
                    for b in range(n_valid):
                        monitor.put(int(frame_ids[b]), lane_frames[b])
            else:
                # The oracle's fetch: the whole batch, padding included.
                frames = out.frames.cpu()
                d2h += frames.numel() * frames.element_size()
                for lane_idx, monitor, frame_ids, n_valid in metas:
                    for b in range(n_valid):
                        monitor.put(int(frame_ids[b]), frames[lane_idx, b])
            with self._report_lock:
                self._d2h_bytes += d2h
                self._phases["deliver_s"] += self._clock() - t0
        finally:
            self._sem.release()
