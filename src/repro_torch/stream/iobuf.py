"""Zero-copy tick I/O: a device-resident lane buffer, donation, and the
host copies on side streams.

The blocking serve tick serialises on its copies three ways: the host
``torch.stack`` of all L lanes, a pageable H2D of the whole batch inside
the step call, and pageable D2H copies on the compute stream, each queued
behind every tick dispatched before it. This module is the overlapped
replacement (README, "Tick I/O & overlap"):

  * :class:`CopyStreams` holds one serve loop's copies on one device. An
    upload goes from pinned host memory on an upload stream, and the
    compute stream (the caller's current stream) waits for it before it
    reads the upload. A fetch runs on a fetch stream that waits on an
    event recorded after its tick on the compute stream, copies into
    pinned host tensors, and waits for its own copies only. On the CPU
    (``device="cpu"``, as the tests ask) they are plain tensor copies.
  * :class:`LaneTickStep` keeps the ``(L, B, H, W, 3)`` wire-dtype frame
    batch on the device. ``stage(lane, frames)`` uploads one lane's batch
    and splices it into the buffer's row on the compute stream, after any
    tick already reading the buffer and before the next one. ``tick(ids,
    state)`` runs the state-donated step (``make_step(...,
    donate="state")``) on the buffer. Padding lanes are never staged:
    their rows hold stale frames that ``frame_id = -1`` makes inert and
    valid-only fetches never copy.
  * :func:`fetch_valid` is the blocking valid-only fetch.

Ownership (who may touch what, until when):

  * the adapter owns its buffer; the step does not donate it (only the
    state), so ``out.frames`` is a tensor of its own that a completion
    may hold as long as it likes;
  * ``out.state`` belongs to the serve loop and is donated into the next
    tick: every read of it (eviction snapshots, admissions) must be
    enqueued on the compute stream before the next ``tick``;
  * a staged lane belongs to the adapter once ``stage`` returns: the
    caller may reuse its host tensor at once;
  * a fetched frame is a view of a pinned host block, and keeps the whole
    block (its tick's lane) alive while any of its frames does: a sink
    that keeps frames keeps pinned memory. Blocks whose frames were all
    dropped go back to PyTorch's pinned caching allocator and are reused.

Every CUDA failure (a stream, a pinned allocation, an event) raises; no
caller falls back to the blocking path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.normalize import AtmoState
from repro_torch.core.pipeline import DeviceLike, resolve_device


def donation_supported() -> bool:
    """Always ``True``: the port implements donation itself
    (``core.pipeline.make_step(..., donate=...)`` writes the new state into
    the state it read, and J into a donated frame buffer), so there is no
    backend to probe, where the reference probes ``jax.jit``'s
    ``donate_argnums`` once."""
    return True


def fetch_valid(frames: torch.Tensor, n_valid: int,
                lane: Optional[int] = None) -> torch.Tensor:
    """Valid-only device-to-host copy: ``frames[lane, :n_valid]`` (or
    ``frames[:n_valid]``) as a CPU tensor; padding never crosses. Blocking,
    on the caller's current stream."""
    view = frames if lane is None else frames[lane]
    return view[:n_valid].cpu()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CopyStreams:
    """The host/device copies of one serve loop on one device (see the
    module docstring). Uploads and small copies return at once; only
    :meth:`fetch` waits, and only for its own copies."""

    def __init__(self, device: DeviceLike = None):
        dev = resolve_device(device)
        self.cuda = dev.type == "cuda"
        if self.cuda and dev.index is None:
            # Compared with tensors' devices, which carry an index.
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if self.cuda:
            self._up = torch.cuda.Stream(self.device)
            self._down = torch.cuda.Stream(self.device)

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` on the device, copied from pinned memory on the upload
        stream; the compute stream waits for the copy before its next work.
        On the CPU (or for a tensor already on the device) ``host`` itself."""
        if not self.cuda or host.device == self.device:
            return host
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._up):
            # Allocated on the upload stream, read on the compute stream:
            # record_stream keeps the allocator from handing the block to
            # the next upload while the compute stream still reads it.
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dev.copy_(pinned, non_blocking=True)
        compute.wait_stream(self._up)
        dev.record_stream(compute)
        return dev

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A small host tensor (ids, a state's fields) on the device, from
        pinned memory on the compute stream, without waiting."""
        if not self.cuda or host.device == self.device:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def own_state(self, state: AtmoState) -> AtmoState:
        """A copy of ``state`` on the device that a donating step may
        consume; the caller's state is never written."""
        if state.A.device == self.device:
            return state.clone()
        return AtmoState(*(self.to_device(t) for t in
                           (state.A, state.last_update, state.initialized)))

    def tick_done(self) -> Optional["torch.cuda.Event"]:
        """An event on the compute stream after the tick just dispatched
        (``None`` on the CPU): what its fetch waits for."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def fetch(self, frames: torch.Tensor,
              parts: Sequence[Tuple[Optional[int], int]],
              done: Optional["torch.cuda.Event"]) -> List[torch.Tensor]:
        """Valid-only copies ``frames[lane, :n]`` (``frames[:n]`` where
        ``lane`` is None) for each ``(lane, n)`` in ``parts``, as host
        tensors. On CUDA: on the fetch stream after ``done``, into pinned
        tensors, waiting for these copies only. The caller holds
        ``frames`` until this returns, so its memory is not reused under
        the copies."""
        if not self.cuda:
            return [fetch_valid(frames, n, lane) for lane, n in parts]
        outs = []
        with torch.cuda.stream(self._down):
            self._down.wait_event(done)
            for lane, n in parts:
                view = (frames if lane is None else frames[lane])[:n]
                host = torch.empty(view.shape, dtype=view.dtype,
                                   pin_memory=True)
                host.copy_(view, non_blocking=True)
                outs.append(host)
            copied = torch.cuda.Event()
            copied.record(self._down)
        copied.synchronize()
        return outs


class LaneTickStep:
    """Device-resident lane buffer + state-donated step, one lane count.

    ``step`` is the lane-batched step built with ``make_step(...,
    donate="state")`` for ``device``. The adapter is call-compatible with
    the raw step: ``adapter(frames, ids, state)`` stages every lane of the
    full batch and ticks (a rung's warm-up). ``stage``/``tick`` belong to
    one serve thread; ``__call__`` is serialised by a lock, so concurrent
    full-batch calls cannot interleave their stages and ticks.
    """

    def __init__(self, step: Callable, n_lanes: int, *,
                 device: DeviceLike = None):
        self._step = step
        self.n_lanes = n_lanes
        self.copies = CopyStreams(device)
        self.device = self.copies.device
        self._buf: Optional[torch.Tensor] = None
        self._call_lock = threading.Lock()
        self.staged_lanes = 0       # stage() calls (live-lane uploads)
        self.staged_bytes = 0       # H2D bytes shipped by stage()

    def ensure_buf(self, lane_shape: Tuple[int, ...], dtype) -> None:
        """(Re)allocate the ``(L,) + lane_shape`` device buffer when the
        lane batch shape or wire dtype changes."""
        shape = (self.n_lanes,) + tuple(lane_shape)
        if (self._buf is None or tuple(self._buf.shape) != shape
                or self._buf.dtype != dtype):
            self._buf = torch.zeros(shape, dtype=dtype, device=self.device)

    def stage(self, lane_idx: int, frames) -> None:
        """Upload one lane's ``(B, H, W, 3)`` batch into its buffer row:
        the copy on the upload stream, the splice on the compute stream
        after it. Makes no synchronising call."""
        frames = torch.as_tensor(frames)
        self.ensure_buf(frames.shape, frames.dtype)
        self._buf[lane_idx].copy_(self.copies.upload(frames))
        self.staged_lanes += 1
        self.staged_bytes += _nbytes(frames)

    def tick(self, frame_ids, state: AtmoState):
        """Run the step on the device-resident buffer. The ids go up from
        pinned memory; a state on the device is donated (the caller must
        not read it after this call; reads enqueued before it are safe), a
        host state is copied up first. Makes no synchronising call."""
        ids = self.copies.to_device(torch.as_tensor(frame_ids,
                                                    dtype=torch.int32))
        if state.A.device != self.device:
            state = self.copies.own_state(state)
        return self._step(self._buf, ids, state)

    def __call__(self, frames, frame_ids, state: AtmoState):
        """Full-batch compatibility path: stage every lane, then tick."""
        with self._call_lock:
            frames = torch.as_tensor(frames)
            for i in range(frames.shape[0]):
                self.stage(i, frames[i])
            return self.tick(frame_ids, state)


class TickBufferPool:
    """One serve call's :class:`LaneTickStep` adapters, one per lane count.

    ``step_factory(n_lanes)`` returns the state-donated lane step for
    ``device`` (``stream.elastic._cached_multi_step(..., donate="state")``);
    ``pool.adapter`` has the signature of a step factory, so the
    overlapped path slots in where a step factory went before. A pool owns
    its device frame buffers and is not shared between serve calls (the
    steps underneath share the bounded step cache)."""

    def __init__(self, step_factory: Callable[[int], Callable], *,
                 device: DeviceLike = None):
        self._factory = step_factory
        self.device = resolve_device(device)
        self._adapters: Dict[int, LaneTickStep] = {}
        self._lock = threading.Lock()

    def adapter(self, n_lanes: int) -> LaneTickStep:
        with self._lock:
            a = self._adapters.get(n_lanes)
            if a is None:
                a = LaneTickStep(self._factory(n_lanes), n_lanes,
                                 device=self.device)
                self._adapters[n_lanes] = a
            return a


def is_overlap_step(step) -> bool:
    """Does ``step`` take the zero-copy path? Anything with ``stage`` and
    ``tick`` (a :class:`LaneTickStep`) does; a plain callable takes the
    blocking path, the parity oracle."""
    return callable(getattr(step, "stage", None)) \
        and callable(getattr(step, "tick", None))


__all__ = ["CopyStreams", "LaneTickStep", "TickBufferPool",
           "donation_supported", "fetch_valid", "is_overlap_step"]
