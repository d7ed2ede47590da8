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

**Deadline-aware eviction** (``evict_tardy_after``): a stream past its
deadline (``clock() >= deadline``) that has held a lane for that many
ticks while others queue is preempted. Its cursor and EMA state are
checkpointed into a :class:`_Resume`, and it requeues as deadline-less
(FIFO behind the queue, priority kept) with the same frame iterator, so it
continues where it stopped. Re-admission waits until the old monitor has
drained, so the sink sees every frame once and in order, and the report
counts the stream's segments as one.

**Elastic lane autoscaling** (``autoscaler``, a
``stream.autoscale.LaneAutoscaler``): the lane count walks a ladder of
warmed rungs from the pending-queue depth and the occupancy. A switch
compacts the live lanes to the low indices and gathers their state rows
into the new rung's state on the state's device (``repack_lanes``:
bit-exact, no synchronising call), enqueued on the compute stream before
the next tick donates it; the new rung's step was warmed off the serve
thread, so the switch is a dictionary lookup.

The four pending-queue hooks (``_queue_depth``, ``_push_requeue``,
``_wait_pending``, ``_pop_ready``) are where the fleet tier
(``stream.fleet``) reroutes a host's scheduler to its shared queue.
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
                                        init_atmo_state_lanes, repack_lanes,
                                        set_lane_state)
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
    # Committed autoscale rung changes and the serve thread's seconds in
    # them; deadline preemptions (all 0 outside autoscale / eviction).
    ladder_switches: int = 0
    switch_wall_s: float = 0.0
    evictions: int = 0
    # Ladder rungs whose warm-up failed twice (autoscale only, summed over
    # the hosts of a fleet): part of the ladder is unreachable, which a
    # serve that expects switches treats as a failure
    # (launch/serve.py --expect-switches).
    warm_failures: int = 0
    # The fleet tier (stream.fleet): hosts, admissions that left their
    # preferred host because its lanes were full, and admissions of a
    # stream on a host other than its first (0 by construction; reported
    # so that serving code can assert it).
    n_hosts: int = 1
    spillovers: int = 0
    migrations: int = 0

    @property
    def fps(self) -> float:
        """Throughput: total frames across streams per wall second."""
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    # The fleet-level name of the same number.
    aggregate_fps = fps


@dataclasses.dataclass
class _Resume:
    """The checkpoint a preempted stream carries back through the pending
    queue. Admission reads the state and cursor from here, not from the
    store (the store is written by the background finalizer, and reading
    it first could resume from a stale cursor); ``barrier`` is set once
    the old monitor has drained, and re-admission waits for it."""
    state: AtmoState
    cursor: int
    barrier: threading.Event


class _Lane:
    """Host-side bookkeeping for one occupied lane."""
    __slots__ = ("request", "raw_it", "it", "monitor", "mon_thread", "start",
                 "frames_done", "ticks", "admitted_at")

    def __init__(self, request: StreamRequest, raw_it, it, monitor: Monitor,
                 mon_thread: threading.Thread, start: int,
                 admitted_at: float):
        self.request = request
        # The frame iterator the spout reads: a requeued stream continues
        # from it (the spout reads no further ahead than the batch it
        # yields, so the iterator and the cursor stay in step).
        self.raw_it = raw_it
        self.it = it
        self.monitor = monitor
        self.mon_thread = mon_thread
        self.start = start
        self.frames_done = 0
        self.ticks = 0
        self.admitted_at = admitted_at

    @property
    def stream_id(self) -> str:
        return self.request.stream_id


class MultiStreamScheduler:
    """Drives ``step(frames (L,B,H,W,3), ids (L,B), state) -> DehazeOutput``
    over many live streams with lane admission, eviction and reuse.

    ``autoscaler`` (a ``stream.autoscale.LaneAutoscaler``) makes the lane
    count elastic: ``n_lanes`` is then the starting rung. With
    ``evict_tardy_after`` a past-deadline stream is preempted (module
    docstring); ``clock`` is what deadlines are compared with.
    ``tick_delay_s`` adds a sleep to every tick on the serve thread (a
    simulated device service time, as the reference's fleet benchmarks
    use it); ``max_skipped_ids`` bounds each monitor's list of skipped
    ids."""

    def __init__(self, step: Callable, store: StreamStateStore,
                 n_lanes: int, batch: int = 8, timeout_s: float = 0.020,
                 max_in_flight: int = 4, max_skipped_ids: int = 64,
                 autoscaler=None, evict_tardy_after: Optional[int] = None,
                 clock: Callable[[], float] = DEADLINE_CLOCK,
                 tick_delay_s: float = 0.0,
                 shutdown_timeout_s: float = 30.0):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self._step = step
        self.store = store
        self.n_lanes = n_lanes
        self.batch = batch
        self.timeout_s = timeout_s
        self.max_skipped_ids = max_skipped_ids
        self._sem = threading.Semaphore(max_in_flight)
        self._autoscaler = autoscaler
        self._evict_tardy_after = evict_tardy_after
        self._clock = clock
        self._tick_delay_s = tick_delay_s
        self._shutdown_timeout_s = shutdown_timeout_s

    # -- lane lifecycle ----------------------------------------------------

    def _admit(self, lane_idx: int, req: StreamRequest,
               resume: Optional[_Resume], packed: AtmoState,
               sink: Optional[MultiSink]) -> AtmoState:
        sid = req.stream_id
        if resume is not None:
            start, state = resume.cursor, resume.state
        else:
            start, state = self.store.cursor(sid), self.store.get(sid)

        def write(fid: int, payload: torch.Tensor) -> None:
            if sink is not None:
                sink(sid, fid, payload)

        monitor = Monitor(write, timeout_s=self.timeout_s, start_frame=start,
                          clock=self._clock,
                          max_skipped_ids=self.max_skipped_ids)
        mon_thread = threading.Thread(target=monitor.run, daemon=True)
        mon_thread.start()
        raw_it = iter(req.frames)
        spout = Spout(raw_it, batch=self.batch, start_frame=start,
                      stream_id=sid)
        self._lanes[lane_idx] = _Lane(req, raw_it, iter(spout), monitor,
                                      mon_thread, start, time.perf_counter())
        self._admissions += 1
        return set_lane_state(packed, lane_idx, state)

    def _evict(self, lane_idx: int, packed: AtmoState,
               requeue: bool = False) -> None:
        """Free the lane now; finalize in the background (wait for the
        in-flight completions that may still hold this stream's frames,
        drain its monitor, persist state + cursor, add this segment to the
        stream's report).

        ``requeue=True`` is the deadline preemption: the stream goes back
        on the pending queue as deadline-less with a :class:`_Resume` of
        this same snapshot and cursor, whose barrier the finalizer sets
        once the old monitor has drained."""
        lane = self._lanes[lane_idx]
        self._lanes[lane_idx] = None
        final_state = get_lane_state(packed, lane_idx)
        cursor = lane.start + lane.frames_done
        waits = list(self._inflight)
        wall_s = time.perf_counter() - lane.admitted_at
        barrier = threading.Event() if requeue else None

        def finalize() -> None:
            for th in waits:
                th.join()
            lane.monitor.close()
            lane.mon_thread.join(timeout=5.0)
            lane.monitor.drain()
            self.store.update(lane.stream_id, final_state, cursor)
            with self._report_lock:
                prev = self._reports.get(lane.stream_id)
                self._reports[lane.stream_id] = StreamReport(
                    stream_id=lane.stream_id,
                    frames=lane.frames_done + (prev.frames if prev else 0),
                    skipped=lane.monitor.stats.skipped
                    + (prev.skipped if prev else 0),
                    wall_s=wall_s + (prev.wall_s if prev else 0.0))
            if barrier is not None:
                barrier.set()

        th = threading.Thread(target=finalize, daemon=True)
        th.start()
        self._finalizers.append(th)

        if requeue:
            self._evictions += 1
            # A stream past its deadline loses its EDF place: deadline-less,
            # priority kept, FIFO behind the queue; the same iterator.
            req = StreamRequest(lane.stream_id, lane.raw_it, deadline=None,
                                priority=lane.request.priority)
            arrival = self._arrival
            self._arrival += 1
            self._push_requeue(req.admission_key(arrival), req,
                               _Resume(final_state, cursor, barrier))

    # -- the pending queue (the fleet tier overrides these four) -----------

    def _queue_depth(self) -> int:
        """Streams waiting for a lane (this scheduler's view)."""
        return len(self._pending)

    def _push_requeue(self, key, req: StreamRequest,
                      resume: _Resume) -> None:
        """Return a preempted stream to the pending queue."""
        heapq.heappush(self._pending, (key, req, resume))

    def _wait_pending(self) -> bool:
        """No live lane: ``True`` when pending work may still become
        admissible (wait briefly, then retry), ``False`` when drained. On
        one host every pending entry is then a preempted stream whose old
        monitor is still draining: wait for the earliest barrier."""
        if self._pending:
            self._pending[0][2].barrier.wait(timeout=0.1)
            return True
        return False

    def _pop_ready(self):
        """Pop the best pending entry whose resume barrier (if any) is set;
        entries still draining their previous segment stay queued."""
        deferred, entry = [], None
        while self._pending:
            cand = heapq.heappop(self._pending)
            if cand[2] is None or cand[2].barrier.is_set():
                entry = cand
                break
            deferred.append(cand)
        for d in deferred:
            heapq.heappush(self._pending, d)
        return entry

    def _fill_lane(self, lane_idx: int, packed: AtmoState,
                   sink: Optional[MultiSink]
                   ) -> Tuple[Optional[FrameBatch], AtmoState]:
        """Next batch for a lane: an exhausted stream is evicted and the
        lane immediately reused by the next admissible pending stream."""
        while True:
            if self._lanes[lane_idx] is None:
                entry = self._pop_ready()
                if entry is None:
                    return None, packed
                _, req, resume = entry
                packed = self._admit(lane_idx, req, resume, packed, sink)
                # The error path's evictions must see this stream's state.
                self._packed = packed
            fb = next(self._lanes[lane_idx].it, None)
            if fb is not None:
                return fb, packed
            self._evict(lane_idx, packed)

    # -- the elastic lane count --------------------------------------------

    def _switch_lanes(self, new_n: int, packed: AtmoState) -> AtmoState:
        """Repack the live lanes onto ``new_n`` lanes: the occupied lanes
        compact to the low indices, their state rows gathered with them
        (bit-exact). Host bookkeeping moves by reference; ticks in flight
        keep the old tensors, and their metas hold monitors, not lane
        indices."""
        occ = [i for i, ln in enumerate(self._lanes) if ln is not None]
        if len(occ) > new_n:
            raise ValueError(
                f"cannot shrink to {new_n} lanes with {len(occ)} occupied")
        new_packed = repack_lanes(packed, occ, new_n)
        self._lanes = [self._lanes[i] for i in occ] \
            + [None] * (new_n - len(occ))
        self.n_lanes = new_n
        return new_packed

    def _maybe_autoscale(self, packed: AtmoState) -> AtmoState:
        occupied = sum(1 for ln in self._lanes if ln is not None)
        target = self._autoscaler.observe(self._queue_depth(), occupied)
        if target is None or target == self.n_lanes or occupied > target:
            return packed
        t0 = time.perf_counter()
        # A lookup: observe() offers warm rungs only.
        self._step = self._autoscaler.step_for(target)
        packed = self._switch_lanes(target, packed)
        self._autoscaler.commit(target, time.perf_counter() - t0)
        return packed

    def _evict_tardy(self, packed: AtmoState) -> None:
        """Preempt every past-deadline stream that has held its lane for
        ``evict_tardy_after`` ticks, while other streams queue."""
        for i, lane in enumerate(self._lanes):
            if self._queue_depth() == 0:
                return
            if (lane is not None and lane.request.deadline is not None
                    and lane.ticks >= self._evict_tardy_after
                    and self._clock() >= lane.request.deadline):
                self._evict(i, packed, requeue=True)

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
        # Heap entries (key, request, resume): keys are unique (arrival
        # breaks ties), so the other two are never compared.
        self._pending: List[tuple] = []
        for arrival, req in enumerate(requests):
            heapq.heappush(self._pending,
                           (req.admission_key(arrival), req, None))
        self._arrival = len(requests)
        self._lanes: List[Optional[_Lane]] = [None] * self.n_lanes
        self._inflight: List[threading.Thread] = []
        self._finalizers: List[threading.Thread] = []
        self._reports: Dict[str, StreamReport] = {}
        self._report_lock = threading.Lock()
        self._admissions = 0
        self._evictions = 0
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
            # every completion and finalizer thread, and for the ladder's
            # warm-ups, whose launches belong to this call.
            for i in range(len(self._lanes)):
                if self._lanes[i] is not None:
                    self._evict(i, self._packed)
            deadline = time.perf_counter() + self._shutdown_timeout_s
            for th in self._inflight + self._finalizers:
                th.join(timeout=max(0.0, deadline - time.perf_counter()))
                if th.is_alive():
                    self._stragglers += 1
            if self._autoscaler is not None and not \
                    self._autoscaler.wait_warm(timeout=max(
                        0.0, deadline - time.perf_counter())):
                self._stragglers += 1
        wall = time.perf_counter() - t0
        reports = self._reports
        scaler = self._autoscaler
        return ServeReport(
            per_stream=reports,
            frames=sum(r.frames for r in reports.values()),
            skipped=sum(r.skipped for r in reports.values()),
            wall_s=wall, n_lanes=self.n_lanes, ticks=ticks,
            admissions=self._admissions, overlap_ticks=self._overlap_ticks,
            stragglers=self._stragglers, d2h_bytes=self._d2h_bytes,
            phases=dict(self._phases),
            ladder_switches=len(scaler.switches) if scaler else 0,
            switch_wall_s=sum(s["wall_s"] for s in scaler.switches)
            if scaler else 0.0,
            evictions=self._evictions,
            warm_failures=scaler.warm_failures if scaler else 0)

    def _tick_loop(self, sink: Optional[MultiSink]) -> int:
        ticks = 0
        packed = self._packed
        pad_frames: Optional[torch.Tensor] = None
        pad_ids = torch.full((self.batch,), -1, dtype=torch.int32)
        while True:
            if self._evict_tardy_after is not None:
                self._evict_tardy(packed)
            fbs: List[Optional[FrameBatch]] = []
            for i in range(len(self._lanes)):
                fb, packed = self._fill_lane(i, packed, sink)
                self._packed = packed
                fbs.append(fb)
            live = [fb for fb in fbs if fb is not None]
            if not live:
                if self._wait_pending():
                    continue
                break
            if pad_frames is None:
                pad_frames = torch.zeros_like(live[0].frames)
            if self._autoscaler is not None:
                self._autoscaler.ensure_warming(tuple(pad_frames.shape),
                                                pad_frames.dtype)
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
                    self._lanes[i].ticks += 1

            self._sem.acquire()
            t_step = self._clock()
            if overlap:
                # The state is donated into this tick: every read of
                # `packed` (eviction snapshots, admissions, rung repacks)
                # was enqueued on the compute stream before it.
                out = self._step.tick(ids, packed)
                done = self._step.copies.tick_done()
                self._overlap_ticks += 1
            else:
                out = self._step(frames, ids, packed)
                done = None
            packed = out.state                 # on the device, maybe in flight
            self._packed = packed
            if self._tick_delay_s > 0.0:
                time.sleep(self._tick_delay_s)
            self._phases["device_step_s"] += self._clock() - t_step
            th = threading.Thread(target=self._complete,
                                  args=(metas, out, overlap, done,
                                        self._step),
                                  daemon=True)
            th.start()
            self._inflight.append(th)
            self._inflight = [t for t in self._inflight if t.is_alive()]
            ticks += 1

            if self._autoscaler is not None:
                packed = self._maybe_autoscale(packed)
                self._packed = packed
        return ticks

    def _complete(self, metas, out, overlap: bool, done, step) -> None:
        """Deliver one tick; ``done`` is the overlapped tick's event and
        ``step`` the step that ran it (a rung switch may have replaced
        ``self._step`` since)."""
        try:
            t0 = self._clock()
            d2h = 0
            if overlap:
                # Valid-only fetches of the live lanes on the fetch stream.
                fetched = step.copies.fetch(
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
