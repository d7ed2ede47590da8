"""The dispatcher: paper §3.2 layers 2-4 on one device.

Drives the dehaze step over a stream of frame batches with:
  - a bounded in-flight window (backpressure): CUDA work is queued
    asynchronously, so batch k+1 is enqueued while batch k runs;
  - per-batch completion threads that wait for the device result, copy
    only the valid frames to the host (``stream.iobuf.fetch_valid``) and
    feed the Monitor, possibly out of order (the layer-4 -> layer-5
    hand-off);
  - sequential state threading: the EMA state of batch k feeds batch k+1
    on the device, keeping the §3.3 coherence chain across batches;
  - an optional zero-copy mode (``overlap=True``, README "Tick I/O &
    overlap"): each batch and its ids go up from pinned memory on the
    upload stream ahead of the call (``stream.iobuf.CopyStreams``), the
    step is built with full donation (``make_step(..., donate=True)``: J
    goes into the uploaded batch where the dtypes allow, the state chain
    allocates nothing), and the valid frames come back on the fetch
    stream;
  - logical workers that round-robin batches (straggler simulation).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional

from repro_torch.core.normalize import AtmoState
from repro_torch.core.pipeline import DeviceLike
from repro_torch.stream.iobuf import CopyStreams, fetch_valid
from repro_torch.stream.monitor import Monitor
from repro_torch.stream.spout import FrameBatch


@dataclass
class DispatchStats:
    batches: int = 0
    frames: int = 0
    wall_s: float = 0.0
    # Batches dispatched through the zero-copy path.
    overlap_batches: int = 0
    d2h_bytes: int = 0
    phases: Dict[str, float] = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0


class StreamDispatcher:
    """Runs ``step(frames, frame_ids, state) -> DehazeOutput`` over a stream."""

    def __init__(self, step: Callable, monitor: Monitor,
                 max_in_flight: int = 4, n_workers: int = 1,
                 worker_delay_s: Optional[Callable[[int], float]] = None,
                 overlap: bool = False, device: DeviceLike = None):
        """``overlap`` takes the zero-copy mode, whose copies run on
        ``device``'s side streams; ``step`` must then donate (``make_step(...,
        donate=True)``) and run on ``device``."""
        self._step = step
        self._copies = CopyStreams(device) if overlap else None
        self._monitor = monitor
        self._sem = threading.Semaphore(max_in_flight)
        self._n_workers = max(1, n_workers)
        self._worker_delay = worker_delay_s
        self._stats_lock = threading.Lock()
        self.stats = DispatchStats(
            phases={"host_stage_s": 0.0, "device_step_s": 0.0,
                    "deliver_s": 0.0})

    def run(self, batches: Iterable[FrameBatch],
            state: AtmoState) -> AtmoState:
        """Serve every batch; return the final state on the host. The
        caller's ``state`` is never written."""
        t0 = time.perf_counter()
        threads = []
        copies = self._copies
        if copies is not None:
            # The donating step writes the new state into the one it reads.
            state = copies.own_state(state)
        for batch_idx, fb in enumerate(batches):
            t_stage = time.perf_counter()
            if copies is not None:
                # The H2D of batch k+1 overlaps batch k's compute; the
                # uploaded batch is single-use (J may go into it).
                frames = copies.upload(fb.frames)
                ids = copies.to_device(fb.frame_ids)
            else:
                frames, ids = fb.frames, fb.frame_ids
            self._phase("host_stage_s", time.perf_counter() - t_stage)
            self._sem.acquire()
            t_step = time.perf_counter()
            out = self._step(frames, ids, state)
            done = copies.tick_done() if copies is not None else None
            self._phase("device_step_s", time.perf_counter() - t_step)
            state = out.state
            th = threading.Thread(
                target=self._complete,
                args=(fb, out, batch_idx % self._n_workers, done),
                daemon=True)
            th.start()
            threads.append(th)
            self.stats.batches += 1
            self.stats.frames += fb.n_valid
            if copies is not None:
                self.stats.overlap_batches += 1
        for th in threads:
            th.join()
        self.stats.wall_s = time.perf_counter() - t0
        return state.to("cpu")

    def _phase(self, key: str, dt: float) -> None:
        with self._stats_lock:
            self.stats.phases[key] = self.stats.phases.get(key, 0.0) + dt

    def _complete(self, fb: FrameBatch, out: Any, worker: int, done) -> None:
        try:
            t0 = time.perf_counter()
            if self._copies is not None:
                frames = self._copies.fetch(out.frames, [(None, fb.n_valid)],
                                            done)[0]
            else:
                frames = fetch_valid(out.frames, fb.n_valid)
            if self._worker_delay is not None:
                time.sleep(self._worker_delay(worker))
            for i in range(fb.n_valid):
                self._monitor.put(int(fb.frame_ids[i]), frames[i])
            with self._stats_lock:
                self.stats.d2h_bytes += frames.numel() * frames.element_size()
            self._phase("deliver_s", time.perf_counter() - t0)
        finally:
            self._sem.release()
