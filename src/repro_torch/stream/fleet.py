"""The fleet tier: one front door over N host-level lane schedulers
(paper §4: several machines serving behind one entry point).

  * **Global EDF** — every pending stream waits in ONE admission queue
    ordered by the single-host key ``(priority, deadline, arrival)``, so
    the fleet's earliest deadline is admitted next, on whichever host has
    the free lane.
  * **Sticky placement** — a stream's first admission pins it to its
    host, and every re-admission (a deadline preemption's requeue) goes
    back there: a stream's EMA state never moves between hosts, and
    ``ServeReport.migrations`` is 0 (reported so callers can assert it).
  * **Spillover** — a fresh stream prefers the host its placement policy
    names; when that host's lanes are all claimed it is admitted on
    whichever host asks (``ServeReport.spillovers``).

Each host runs an unmodified ``MultiStreamScheduler`` serve loop
(admission, eviction, its own ``LaneAutoscaler``) on a thread of its own;
the subclass only reroutes the four pending-queue hooks to the shared
queue. The hosts are threads over one device and share its compute
stream (each thread's current stream, the default one): a host never
touches another host's tensors, and as each lane's computation is
independent of the others, the interleaving of the hosts' launches
changes no value.

Placement policies: ``"first-fit"`` (default) prefers host 0 for every
fresh stream, so hosts fill in order and spillover is deterministic;
``"hash"`` spreads streams by the CRC32 of the stream id; a callable
``sid -> host`` plugs in anything else.

``sink`` runs on the hosts' monitor threads at once: a fleet sink must be
safe across different streams (each stream's calls stay ordered).
"""
from __future__ import annotations

import bisect
import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence, Union

from repro_torch.stream.monitor import DEADLINE_CLOCK
from repro_torch.stream.scheduler import (MultiSink, MultiStreamScheduler,
                                          ServeReport, StreamRequest, _Resume)
from repro_torch.stream.state import StreamStateStore

PlacementPolicy = Union[str, Callable[[str], int]]


def _resolve_policy(policy: PlacementPolicy, n_hosts: int
                    ) -> Callable[[str], int]:
    if callable(policy):
        return lambda sid: int(policy(sid)) % n_hosts
    if policy == "first-fit":
        return lambda sid: 0
    if policy == "hash":
        return lambda sid: zlib.crc32(sid.encode()) % n_hosts
    raise ValueError(
        f"placement_policy must be 'first-fit', 'hash' or a callable, "
        f"got {policy!r}")


class _FleetQueue:
    """The shared admission queue: a sorted list of ``(key, seq, req,
    resume, pin)`` entries (``key`` the global EDF key, arrivals assigned
    fleet-wide so keys are unique; ``pin`` forces a host). ``pop_for``
    returns the best entry a host may take under stickiness and
    spillover; ``active`` against each host's lanes decides when a host
    other than the preferred one may take a fresh stream."""

    def __init__(self, n_hosts: int, lanes_per_host: int,
                 prefer: Callable[[str], int]):
        self._entries: List[tuple] = []
        self._lock = threading.Lock()
        self._seq = 0
        self._arrival = 0
        self._prefer = prefer
        self._cap = [lanes_per_host] * n_hosts
        self._active = [0] * n_hosts
        # Stream id -> host of its first admission; never rewritten.
        self.placements: dict = {}
        self.spillovers = 0
        self.migrations = 0
        # One record per admission: {"stream_id", "host", "spillover",
        # "resumed"}.
        self.admission_log: List[dict] = []

    def _push(self, key, req: StreamRequest, resume: Optional[_Resume],
              pin: Optional[int]) -> None:
        bisect.insort(self._entries, (key, self._seq, req, resume, pin))
        self._seq += 1

    def seed(self, req: StreamRequest) -> None:
        with self._lock:
            self._push(req.admission_key(self._arrival), req, None, None)
            self._arrival += 1

    def push_requeue(self, req: StreamRequest, resume: _Resume,
                     pin: int) -> None:
        """A preempted stream: re-keyed with a fleet-wide arrival (FIFO
        behind the queue) and pinned to its host."""
        with self._lock:
            self._active[pin] -= 1
            self._push(req.admission_key(self._arrival), req, resume, pin)
            self._arrival += 1

    def note_freed(self, host: int) -> None:
        """A lane of ``host`` was released without a requeue."""
        with self._lock:
            self._active[host] -= 1

    def empty(self) -> bool:
        with self._lock:
            return not self._entries

    def depth_for(self, host: int) -> int:
        """Entries ``host`` could admit: pinned or placed there, or not
        placed yet."""
        with self._lock:
            n = 0
            for _, _, req, _, pin in self._entries:
                target = pin if pin is not None \
                    else self.placements.get(req.stream_id)
                if target is None or target == host:
                    n += 1
            return n

    def pop_for(self, host: int):
        """The best admissible entry for ``host`` in EDF order, or None:
        a resume still draining stays queued; a placed or pinned stream
        goes only to its host; a fresh one to its preferred host, or to
        ``host`` when the preferred host's lanes are all claimed."""
        with self._lock:
            for i, (key, _seq, req, resume, pin) in enumerate(self._entries):
                if resume is not None and not resume.barrier.is_set():
                    continue
                sid = req.stream_id
                target = pin if pin is not None else self.placements.get(sid)
                spill = False
                if target is not None:
                    if target != host:
                        continue
                else:
                    pref = self._prefer(sid)
                    if pref != host:
                        if self._active[pref] < self._cap[pref]:
                            continue
                        spill = True
                prev = self.placements.get(sid)
                if prev is not None and prev != host:
                    self.migrations += 1        # excluded above
                self.placements[sid] = host
                self._active[host] += 1
                if spill:
                    self.spillovers += 1
                self.admission_log.append({
                    "stream_id": sid, "host": host, "spillover": spill,
                    "resumed": resume is not None})
                del self._entries[i]
                return key, req, resume
            return None


class _HostScheduler(MultiStreamScheduler):
    """One host's serve loop, its pending queue the fleet's."""

    def __init__(self, fleet_queue: _FleetQueue, host_id: int, **kwargs):
        super().__init__(**kwargs)
        self._fleet_q = fleet_queue
        self._host_id = host_id

    def _queue_depth(self) -> int:
        return self._fleet_q.depth_for(self._host_id)

    def _pop_ready(self):
        return self._fleet_q.pop_for(self._host_id)

    def _push_requeue(self, key, req, resume) -> None:
        del key                      # re-keyed with a fleet-wide arrival
        self._fleet_q.push_requeue(req, resume, pin=self._host_id)

    def _evict(self, lane_idx: int, packed, requeue: bool = False) -> None:
        super()._evict(lane_idx, packed, requeue=requeue)
        if not requeue:              # a requeue has rebalanced the count
            self._fleet_q.note_freed(self._host_id)

    def _wait_pending(self) -> bool:
        # Another host may still fill up and spill work this way: poll
        # until the fleet's queue is drained.
        if self._fleet_q.empty():
            return False
        time.sleep(0.005)
        return True


class FleetScheduler:
    """``n_hosts`` lane schedulers behind one front door (module
    docstring).

    ``step`` is every host's step unless ``step_factory(host)`` gives each
    host its own (the overlapped path: a ``LaneTickStep``'s device buffer
    belongs to one serve loop) or ``autoscaler_factory(host)`` gives each
    host a ``LaneAutoscaler``, whose first rung is then its step. The
    steps underneath share the bounded step cache. ``n_lanes`` is per
    host; ``tick_delay_s`` is the scheduler's simulated device time."""

    def __init__(self, step: Callable, store: StreamStateStore,
                 n_hosts: int, n_lanes: int, batch: int = 8,
                 timeout_s: float = 0.020, max_in_flight: int = 4,
                 max_skipped_ids: int = 64,
                 autoscaler_factory: Optional[Callable[[int], object]] = None,
                 evict_tardy_after: Optional[int] = None,
                 clock: Callable[[], float] = DEADLINE_CLOCK,
                 placement_policy: PlacementPolicy = "first-fit",
                 tick_delay_s: float = 0.0,
                 step_factory: Optional[Callable[[int], Callable]] = None):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        self.n_hosts = n_hosts
        self.n_lanes = n_lanes
        self._prefer = _resolve_policy(placement_policy, n_hosts)
        self._autoscaler_factory = autoscaler_factory
        self._step_factory = step_factory
        self._kw = dict(step=step, store=store, batch=batch,
                        timeout_s=timeout_s, max_in_flight=max_in_flight,
                        max_skipped_ids=max_skipped_ids,
                        evict_tardy_after=evict_tardy_after, clock=clock,
                        tick_delay_s=tick_delay_s)
        self.queue: Optional[_FleetQueue] = None

    def _build_hosts(self, queue: _FleetQueue) -> List[_HostScheduler]:
        hosts = []
        for h in range(self.n_hosts):
            scaler = (self._autoscaler_factory(h)
                      if self._autoscaler_factory is not None else None)
            kw = dict(self._kw)
            if scaler is not None:
                kw["step"] = scaler.acquire_initial()
                n_lanes = scaler.rung
            else:
                n_lanes = self.n_lanes
                if self._step_factory is not None:
                    kw["step"] = self._step_factory(h)
            hosts.append(_HostScheduler(queue, h, n_lanes=n_lanes,
                                        autoscaler=scaler, **kw))
        return hosts

    def run(self, streams: Sequence[StreamRequest],
            sink: Optional[MultiSink] = None) -> ServeReport:
        requests = list(streams)
        for r in requests:
            if not isinstance(r, StreamRequest):
                raise TypeError(f"expected StreamRequest, got "
                                f"{type(r).__name__}")
        sids = [r.stream_id for r in requests]
        if len(set(sids)) != len(sids):
            dupes = sorted({s for s in sids if sids.count(s) > 1})
            raise ValueError(f"duplicate stream ids in one fleet serve: "
                             f"{dupes}")
        queue = _FleetQueue(self.n_hosts, self.n_lanes, self._prefer)
        self.queue = queue
        for req in requests:
            queue.seed(req)
        hosts = self._build_hosts(queue)

        reports: List[Optional[ServeReport]] = [None] * self.n_hosts
        errors: List[BaseException] = []

        def serve_host(h: int) -> None:
            try:
                reports[h] = hosts[h].run([], sink=sink)
            except BaseException as e:          # raised after the join
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=serve_host, args=(h,),
                                    name=f"fleet-host-{h}", daemon=True)
                   for h in range(self.n_hosts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]

        done = [r for r in reports if r is not None]
        per_stream = {}
        phases: dict = {}
        for r in done:
            per_stream.update(r.per_stream)
            for k, v in r.phases.items():
                phases[k] = phases.get(k, 0.0) + v

        def total(field: str):
            return sum(getattr(r, field) for r in done)

        return ServeReport(
            per_stream=per_stream, frames=total("frames"),
            skipped=total("skipped"), wall_s=wall,
            n_lanes=total("n_lanes"), ticks=total("ticks"),
            admissions=total("admissions"),
            overlap_ticks=total("overlap_ticks"),
            stragglers=total("stragglers"), d2h_bytes=total("d2h_bytes"),
            phases=phases, ladder_switches=total("ladder_switches"),
            switch_wall_s=total("switch_wall_s"),
            evictions=total("evictions"),
            warm_failures=total("warm_failures"), n_hosts=self.n_hosts,
            spillovers=queue.spillovers, migrations=queue.migrations)


__all__ = ["FleetScheduler", "PlacementPolicy"]
