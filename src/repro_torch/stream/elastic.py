"""The serving front door: ``ElasticServer.serve`` and ``serve_many``.

``serve`` runs one stream through the dispatcher; ``serve_many`` runs N
streams through the lane scheduler, whose step runs all L lanes of a tick
in one call: the lane-native megakernel on a fused config, otherwise (the
default ``kernel_mode="auto"``) the staged component kernels, each launched
once over the tick's L*B frames. Steps come from a bounded LRU cache keyed
by everything that shapes them. The server runs
on CUDA unless it is built with ``device="cpu"``; without a card a CUDA
server raises when it is built.

``tick_overlap=True`` (or ``REPRO_TICK_OVERLAP=1``) takes the zero-copy
tick path of ``stream.iobuf`` (README, "Tick I/O & overlap"): donated
steps, uploads from pinned memory on a side stream, valid-only fetches on
another. Its outputs equal the blocking path's bit for bit.

``serve_many(autoscale=True)`` walks a ladder of warmed lane counts
(``stream.autoscale``); a ``policy`` also sets deadline-aware eviction;
``n_hosts > 1`` serves through the fleet tier (``stream.fleet``): host
schedulers on threads over this server's device, behind one global-EDF
queue with sticky placement.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

import torch

from repro_torch.core import env as _env
from repro_torch.core.config import DehazeConfig
from repro_torch.core.pipeline import (DeviceLike, make_step, resolve_device,
                                       resolve_lane_native)
from repro_torch.core.placement import PlacementSpec
from repro_torch.stream import iobuf
from repro_torch.stream.autoscale import (LaneAutoscaler, ScalePolicy,
                                          ladder_rungs)
from repro_torch.stream.dispatcher import StreamDispatcher
from repro_torch.stream.fleet import FleetScheduler, PlacementPolicy
from repro_torch.stream.monitor import DEADLINE_CLOCK, Monitor
from repro_torch.stream.scheduler import (MultiStreamScheduler, ServeReport,
                                          StreamReport, StreamRequest)
from repro_torch.stream.spout import Spout
from repro_torch.stream.state import StreamStateStore


class _LRUStepCache:
    """Bounded step cache: the ``maxsize`` most recently used steps."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, build: Callable):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        step = build()                       # build outside the lock
        with self._lock:
            self._d[key] = step
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
        return step


_STEP_CACHE = _LRUStepCache(maxsize=_env.step_cache_size())


def _tuning_token() -> tuple:
    """The tuning table's and overrides' state (``tuning.state_token``): a
    step resolves its knobs once a shape, so a step cached under another
    state is not reused."""
    from repro_torch.kernels import tuning
    return tuning.state_token()


def _cached_step(cfg: DehazeConfig, device: torch.device, donate=False):
    """Keyed by the donation contract too (``make_step``'s ``donate``): a
    donating step is never handed to a caller that reuses its inputs; and
    by the tuning state (:func:`_tuning_token`)."""
    return _STEP_CACHE.get(
        ("single", cfg, str(device), donate, _tuning_token()),
        lambda: make_step(cfg, PlacementSpec.single(), device=device,
                          donate=donate))


def _cached_multi_step(cfg: DehazeConfig, n_lanes: int, lane_native: bool,
                       device: torch.device, donate=False):
    """Keyed by lane count, path, donation contract and tuning state too:
    a resize, a ``REPRO_LANE_NATIVE`` toggle, the overlapped path or a
    changed tuning table never reuses a stale step."""
    return _STEP_CACHE.get(
        ("multi", cfg, n_lanes, lane_native, str(device), donate,
         _tuning_token()),
        lambda: make_step(cfg, PlacementSpec.lane_batched(), device=device,
                          lane_native=lane_native, donate=donate))


def _resolve_overlap(tick_overlap: Optional[bool]) -> bool:
    """Does this serve call take the zero-copy overlapped tick path? The
    explicit argument first, then ``REPRO_TICK_OVERLAP``; off when neither
    is set (the blocking path is the default and the parity oracle)."""
    req = tick_overlap if tick_overlap is not None else _env.tick_overlap()
    return bool(req) and iobuf.donation_supported()


class ElasticServer:
    """Serves dehazing streams on one device."""

    def __init__(self, cfg: DehazeConfig, n_workers: int = 1,
                 batch: int = 8, timeout_s: float = 0.020,
                 max_in_flight: int = 4,
                 worker_delay_s: Optional[Callable[[int], float]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.batch = batch
        self.timeout_s = timeout_s
        self.max_in_flight = max_in_flight
        self.store = StreamStateStore()
        self._worker_delay = worker_delay_s
        self.n_workers = n_workers
        # The FleetScheduler of the last multi-host serve_many (its
        # placements and admission log).
        self.last_fleet: Optional[FleetScheduler] = None

    def resize(self, n_workers: int) -> None:
        """Elastic scale of single-stream serving: the worker count of the
        next :meth:`serve` (at least 1). Stream states and cached steps
        are kept."""
        self.n_workers = max(1, n_workers)

    def serve(self, frames: Iterable, stream_id: str = "default",
              sink: Optional[Callable[[int, torch.Tensor], None]] = None,
              tick_overlap: Optional[bool] = None) -> ServeReport:
        """Serve one stream; ``sink(frame_id, frame)`` sees its frames in
        order, each a CPU tensor. ``tick_overlap`` (``None``: follow
        ``REPRO_TICK_OVERLAP``, default off) takes the zero-copy path: a
        fully donated step, uploads and valid-only fetches on side
        streams; the frames are bit-identical either way."""
        overlap = _resolve_overlap(tick_overlap)

        def write(fid: int, payload: torch.Tensor) -> None:
            if sink is not None:
                sink(fid, payload)

        step = _cached_step(self.cfg, self.device, donate=overlap)
        start = self.store.cursor(stream_id)
        monitor = Monitor(write, timeout_s=self.timeout_s, start_frame=start)
        spout = Spout(frames, batch=self.batch, start_frame=start,
                      stream_id=stream_id)
        dispatcher = StreamDispatcher(
            step, monitor, max_in_flight=self.max_in_flight,
            n_workers=self.n_workers, worker_delay_s=self._worker_delay,
            overlap=overlap, device=self.device)
        mon_thread = threading.Thread(target=monitor.run, daemon=True)
        mon_thread.start()
        t0 = time.perf_counter()
        state = dispatcher.run(iter(spout), self.store.get(stream_id))
        monitor.close()
        mon_thread.join(timeout=5.0)
        monitor.drain()
        wall = time.perf_counter() - t0

        self.store.update(stream_id, state, start + dispatcher.stats.frames)
        rep = StreamReport(stream_id=stream_id,
                           frames=dispatcher.stats.frames,
                           skipped=monitor.stats.skipped, wall_s=wall)
        return ServeReport(
            per_stream={stream_id: rep}, frames=rep.frames,
            skipped=rep.skipped, wall_s=wall, n_lanes=self.n_workers,
            ticks=dispatcher.stats.batches,
            overlap_ticks=dispatcher.stats.overlap_batches,
            d2h_bytes=dispatcher.stats.d2h_bytes,
            phases=dict(dispatcher.stats.phases))

    def serve_many(self, streams: Sequence[StreamRequest],
                   n_lanes: Optional[int] = None,
                   sink: Optional[Callable[[str, int, torch.Tensor], None]]
                   = None, autoscale: bool = False,
                   policy: Optional[ScalePolicy] = None,
                   clock: Callable[[], float] = DEADLINE_CLOCK,
                   n_hosts: int = 1,
                   placement: Optional[PlacementSpec] = None,
                   placement_policy: PlacementPolicy = "first-fit",
                   host_delay_s: float = 0.0,
                   tick_overlap: Optional[bool] = None) -> ServeReport:
        """Serve N videos concurrently via lane-batched continuous batching.

        ``streams`` are :class:`StreamRequest` s sharing one (H, W) and wire
        dtype; ``n_lanes`` defaults to one lane per stream (per host:
        ``ceil(len(streams) / n_hosts)``), and with fewer lanes the surplus
        queues in ``(priority, deadline, arrival)`` order and takes lanes
        as they free up. Per stream the outputs, EMA trajectories and
        cursors match sequential :meth:`serve` calls.

        ``autoscale=True`` makes the lane count elastic: ``n_lanes`` is the
        cap, the serve starts at the smallest rung of ``policy.rungs``
        (capped, :func:`~repro_torch.stream.autoscale.ladder_rungs`) and
        walks the ladder under hysteresis, the other rungs warmed off the
        serve thread. A ``policy`` without ``autoscale`` still applies its
        ``evict_tardy_after`` at a fixed lane count.

        ``n_hosts > 1`` (or a ``placement`` with ``n_hosts > 1``) serves
        through a :class:`~repro_torch.stream.fleet.FleetScheduler`:
        ``n_lanes`` lanes on each host, ``placement_policy`` naming each
        fresh stream's preferred host, ``host_delay_s`` a simulated device
        time a tick on each host. Per-stream outputs, states and cursors
        equal the one-host serve's; only the host that runs a stream
        changes.

        ``tick_overlap`` (``None``: follow ``REPRO_TICK_OVERLAP``, default
        off) serves through a :class:`~repro_torch.stream.iobuf.
        TickBufferPool` of this call (one per host of a fleet): live lanes
        staged into a device-resident buffer, the state donated tick to
        tick, valid-only fetches on a side stream. Outputs and final
        states are bit-identical to the blocking path's."""
        overlap = _resolve_overlap(tick_overlap)
        if placement is None:
            placement = PlacementSpec.lane_batched(n_hosts=n_hosts)
        else:
            placement.validate()
            n_hosts = placement.n_hosts
        if placement.sharded:
            raise ValueError(
                "serve_many drives local lane batches; mesh-sharded "
                "placements go through core.make_step(cfg, placement, mesh)")
        if not placement.lanes:
            raise ValueError("serve_many needs a lane placement; use "
                             "PlacementSpec.lane_batched()")
        streams = list(streams)
        if not streams:
            return ServeReport(per_stream={}, frames=0, skipped=0,
                               wall_s=0.0, n_lanes=0, ticks=0)
        lanes = n_lanes if n_lanes is not None \
            else max(1, -(-len(streams) // n_hosts))
        lane_native = resolve_lane_native(self.cfg)
        pol = policy if policy is not None else ScalePolicy()
        evict_after = (pol.evict_tardy_after
                       if autoscale or policy is not None else None)

        def base_step_for(n: int):
            return _cached_multi_step(self.cfg, n, lane_native, self.device,
                                      donate="state" if overlap else False)

        def mk_step_for(_host: int = 0) -> Callable[[int], Callable]:
            """A host's step factory: on the overlapped path a
            TickBufferPool of its own (a device frame buffer belongs to one
            serve loop); the steps underneath share the step cache."""
            if not overlap:
                return base_step_for
            return iobuf.TickBufferPool(base_step_for,
                                        device=self.device).adapter

        def mk_scaler(host: int = 0) -> LaneAutoscaler:
            return LaneAutoscaler(mk_step_for(host),
                                  ladder_rungs(pol.rungs, lanes),
                                  policy=pol, device=self.device)

        kw = dict(batch=self.batch, timeout_s=self.timeout_s,
                  max_in_flight=self.max_in_flight,
                  evict_tardy_after=evict_after, clock=clock,
                  tick_delay_s=host_delay_s)
        if n_hosts > 1:
            fleet = FleetScheduler(
                base_step_for(lanes), self.store, n_hosts=n_hosts,
                n_lanes=lanes, placement_policy=placement_policy,
                autoscaler_factory=mk_scaler if autoscale else None,
                step_factory=((lambda h: mk_step_for(h)(lanes))
                              if overlap else None), **kw)
            self.last_fleet = fleet
            return fleet.run(streams, sink=sink)

        scaler = mk_scaler() if autoscale else None
        if scaler is not None:
            step = scaler.acquire_initial()
            lanes = scaler.rung
        else:
            step = mk_step_for()(lanes)
        scheduler = MultiStreamScheduler(step, self.store, n_lanes=lanes,
                                         autoscaler=scaler, **kw)
        return scheduler.run(streams, sink=sink)


__all__ = ["ElasticServer"]
