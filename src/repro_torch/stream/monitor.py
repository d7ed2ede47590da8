"""The monitor component (paper §3.2 layer 5, Fig. 5), PyTorch port (the
reference's pure-Python module, copied so the port imports nothing of it).

Parallel workers complete frames out of order; the monitor restores stream
order at the sink with a priority queue, a reader that waits up to a
timeout for a missing frame and then *skips* it (the paper's 20 ms reader
rule — the framework's built-in straggler mitigation), and a writer
callback that receives frames strictly in ascending id order.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

# The one deadline/timeout timebase shared by every serving component
# (Monitor reader timeouts, scheduler/fleet EDF ordering and tardy
# eviction, ``serve_many`` wall clocks). Monotonic by design: deadline
# comparisons must not misfire when NTP steps the wall clock — the
# scheduler and the monitor previously defaulted to *different* clocks
# (``time.time`` vs ``time.monotonic``), so a wall-clock step could evict
# lanes or reorder EDF admission spuriously. Inject a fake through the
# ``clock=`` parameters for tests; ``StreamRequest.deadline`` values are
# compared against this clock, so produce them from it too.
DEADLINE_CLOCK: Callable[[], float] = time.monotonic


@dataclass
class MonitorStats:
    emitted: int = 0
    skipped: int = 0                 # running count (never truncated)
    out_of_order_arrivals: int = 0
    max_queue_depth: int = 0
    # Only the most recent ``Monitor.max_skipped_ids`` ids are kept — a
    # lossy long-running stream skips unboundedly, the full history is the
    # count above, the tail is what an operator actually pages through.
    skipped_ids: List[int] = field(default_factory=list)


class Monitor:
    """Order-restoring sink with deadline-based skip.

    Thread-safe: any number of producers call ``put``; one consumer drives
    ``poll`` (or ``run`` in a dedicated thread). ``write_fn(frame_id,
    payload)`` is invoked in order.
    """

    def __init__(self, write_fn: Callable[[int, Any], None],
                 timeout_s: float = 0.020, start_frame: int = 0,
                 clock: Callable[[], float] = DEADLINE_CLOCK,
                 max_skipped_ids: int = 64):
        self._write = write_fn
        self._timeout = timeout_s
        self._next = start_frame
        self._clock = clock
        self._heap: List[tuple] = []
        self._lock = threading.Condition()
        self._deadline: Optional[float] = None
        self._closed = False
        self.max_skipped_ids = max_skipped_ids
        self.stats = MonitorStats()

    def _record_skip_locked(self, frame_id: int) -> None:
        self.stats.skipped += 1
        ids = self.stats.skipped_ids
        ids.append(frame_id)
        if len(ids) > self.max_skipped_ids:
            del ids[:len(ids) - self.max_skipped_ids]

    def put(self, frame_id: int, payload: Any) -> None:
        with self._lock:
            if frame_id >= self._next:
                heapq.heappush(self._heap, (frame_id, payload))
                if frame_id > self._next:
                    self.stats.out_of_order_arrivals += 1
                self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                                 len(self._heap))
            # Late arrival for an already skipped/emitted id is dropped.
            self._lock.notify_all()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- consumer side -----------------------------------------------------

    def _emit_ready_locked(self) -> None:
        while self._heap and self._heap[0][0] == self._next:
            fid, payload = heapq.heappop(self._heap)
            self._write(fid, payload)
            self.stats.emitted += 1
            self._next = fid + 1
            self._deadline = None
        # Drop stale duplicates below the cursor.
        while self._heap and self._heap[0][0] < self._next:
            heapq.heappop(self._heap)

    def poll(self) -> bool:
        """Emit everything currently possible; skip on expired deadline.

        Returns True while the stream may still produce output."""
        with self._lock:
            self._emit_ready_locked()
            if self._heap:
                # A later frame is waiting on a missing earlier one.
                now = self._clock()
                if self._deadline is None:
                    self._deadline = now + self._timeout
                elif now >= self._deadline:
                    # Paper's reader rule: skip the absent frame, move on.
                    self._record_skip_locked(self._next)
                    self._next += 1
                    self._deadline = None
                    self._emit_ready_locked()
            return not (self._closed and not self._heap)

    def run(self, idle_sleep: float = 0.05) -> None:
        """Consumer loop. ``idle_sleep`` is only a safety-net timeout: every
        state change (``put``, ``close``) notifies the condition, so the
        loop wakes immediately when there is work. The old 1 ms default
        made every idle monitor a 1 kHz GIL-contending poll storm — with
        one monitor per stream the multi-tenant scheduler paid it L-fold."""
        while self.poll():
            with self._lock:
                if not self._heap and not self._closed:
                    self._lock.wait(timeout=idle_sleep)
                elif self._heap and self._deadline is not None:
                    self._lock.wait(timeout=max(
                        0.0, self._deadline - self._clock()))

    def drain(self) -> None:
        """Flush remaining frames in order, skipping all gaps (shutdown)."""
        with self._lock:
            while self._heap:
                if self._heap[0][0] != self._next:
                    self._record_skip_locked(self._next)
                    self._next += 1
                else:
                    self._emit_ready_locked()
