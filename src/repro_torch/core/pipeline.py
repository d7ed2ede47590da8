"""Dehazing step builders: the paper's component chain as one step call.

``make_step(cfg, placement)`` builds the step a
:class:`~repro_torch.core.placement.PlacementSpec` declares: the plain
batched step (``single``) or the lane-batched multi-stream step
(``lane_batched``), fused or staged. With ``kernel_mode="fused"`` and a
config the megakernel covers, the single step is the megakernel's L=1
view and the lane step runs all L lanes in one megakernel call
(lane-native). Otherwise (``"auto"``, the default, ``"pallas"``, ``"ref"``
and the fused fallback) the step is the staged component chain; its lane
step runs each component once over all L*B frames, with each lane's own
saved A in the DCP pre-divide and a per-lane EMA.

Every step runs on one device, fixed when it is built: ``device=None``
means CUDA (and raises without a card), ``device="cpu"`` the CPU. The step
moves its inputs there. Buffer donation and the mesh-sharded step of the
reference are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import env as _env
from repro_torch.core.config import DehazeConfig
from repro_torch.core.normalize import (AtmoState, ema_scan,
                                        ema_scan_associative, ema_scan_lanes,
                                        get_lane_state, pack_atmo_states)
from repro_torch.core.placement import PlacementSpec
from repro_torch.kernels import ref as kref

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; otherwise ``torch.device``.
    A CUDA request without a CUDA device raises ``RuntimeError``: nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class DehazeOutput:
    frames: torch.Tensor        # (B, H, W, 3) haze-free J
    transmission: torch.Tensor  # (B, H, W) refined t
    atmo_light: torch.Tensor    # (B, 3) per-frame normalized A
    state: AtmoState


def _ingest(frames: torch.Tensor, cfg: DehazeConfig):
    """``(x, odt)``: the compute view of ``frames`` (float ingest passes
    through, uint8 upcasts through ``kernels.ref.upcast_frames``) and the
    resolved J/t output dtype. The megakernel takes the raw wire frames."""
    odt = kref.resolve_out_dtype(frames.dtype, cfg.out_dtype)
    x = frames if frames.dtype.is_floating_point \
        else kref.upcast_frames(frames)
    return x, odt


def _on(device: torch.device, frames, frame_ids, state: AtmoState):
    return (torch.as_tensor(frames).to(device),
            torch.as_tensor(frame_ids).to(device=device, dtype=torch.int32),
            state.to(device))


def make_step(cfg: DehazeConfig, placement: Optional[PlacementSpec] = None,
              *, device: DeviceLike = None, associative: bool = True,
              lane_native: Optional[bool] = None):
    """Build the step a placement declares:
    ``step(frames, frame_ids, state) -> DehazeOutput``.

    - ``single``: frames (B, H, W, 3), ids (B,), one stream's state;
    - ``lane_batched``: frames (L, B, H, W, 3), ids (L, B), a lane-batched
      state; ``lane_native`` follows :func:`resolve_lane_native` when None.
    """
    placement = (placement if placement is not None
                 else PlacementSpec()).validate()
    cfg = cfg.validate()
    dev = resolve_device(device)
    if placement.lanes:
        step = _make_lane_step(cfg, associative=associative,
                               lane_native=lane_native)
    else:
        step = _make_single_step(cfg, associative=associative)

    def on_device(frames, frame_ids, state: AtmoState) -> DehazeOutput:
        return step(*_on(dev, frames, frame_ids, state))
    return on_device


def _fused_covers(cfg: DehazeConfig) -> bool:
    """Does ``cfg`` select the megakernel (``kernel_mode="fused"`` and a
    config it covers)?"""
    return cfg.kernel_mode == "fused" and alg.supports_fused(cfg)


def _make_single_step(cfg: DehazeConfig, associative: bool = True):
    if _fused_covers(cfg):
        def fused_step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
            out, t, a_seq, new_state = alg.fused_dehaze(frames, frame_ids,
                                                        state, cfg)
            return DehazeOutput(out, t, a_seq.to(out.dtype), new_state)
        return fused_step
    return _make_staged_step(cfg, associative=associative, lanes=False)


def _make_staged_step(cfg: DehazeConfig, associative: bool, lanes: bool):
    """The staged component chain over frames (B, H, W, 3) with one
    stream's state, or (``lanes``) over (L, B, H, W, 3) with a lane-batched
    state: every component runs once over all frames; the DCP pre-divide
    takes each lane's saved A and the EMA runs per lane."""
    t_est = alg.get_transmission_estimator(cfg.algorithm)
    if lanes:
        def scan(a_new, frame_ids, state, period, lam):
            return ema_scan_lanes(a_new, frame_ids, state, period, lam,
                                  associative=associative)
    else:
        scan = ema_scan_associative if associative else ema_scan

    def step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
        x, odt = _ingest(frames, cfg)
        # Component 1: transmission from the *saved* shared A (§3.3).
        t_raw = t_est(x, state.A, cfg)
        # Component 2: per-frame candidates, then cross-frame normalization.
        a_new = alg.estimate_atmospheric_light(x, t_raw, cfg)
        a_seq, new_state = scan(a_new, frame_ids, state, cfg.update_period,
                                cfg.lam)
        a_seq = a_seq.to(x.dtype)
        if cfg.recompute_t_with_final_a and cfg.algorithm == "dcp":
            t_raw = t_est(x, a_seq, cfg)
        t = alg.refine_transmission(x, t_raw, cfg)
        # Component 3: haze-free generation.
        out = alg.generate_haze_free(x, t, a_seq, cfg)
        return DehazeOutput(out.to(odt), t.to(odt), a_seq.to(odt), new_state)

    return step


def make_dehaze_step(cfg: DehazeConfig, associative: bool = True, *,
                     device: DeviceLike = None):
    """``step(frames (B,H,W,3), frame_ids (B,), state) -> DehazeOutput``:
    :func:`make_step` with the single placement."""
    return make_step(cfg, PlacementSpec.single(), device=device,
                     associative=associative)


def resolve_lane_native(cfg: DehazeConfig) -> bool:
    """Lane-native megakernel for the multi-stream step? Yes whenever the
    fused megakernel covers the config; ``REPRO_LANE_NATIVE=0`` forces the
    per-lane path, ``=1`` forces lane-native and raises if the config
    cannot take it."""
    cfg = cfg.validate()
    fused_ok = _fused_covers(cfg)
    forced = _env.lane_native()
    if forced:
        if not fused_ok:
            raise ValueError(
                "REPRO_LANE_NATIVE=1 requires kernel_mode='fused' and a "
                "config the megakernel covers (algorithms.supports_fused); "
                f"got kernel_mode={cfg.kernel_mode!r}, "
                f"algorithm={cfg.algorithm!r}")
        return True
    if forced is not None:
        return False
    return fused_ok


def _make_lane_step(cfg: DehazeConfig, associative: bool = True,
                    lane_native: Optional[bool] = None):
    if lane_native is None:
        lane_native = resolve_lane_native(cfg)
    if lane_native:
        if not _fused_covers(cfg):
            raise ValueError(
                "lane_native=True requires kernel_mode='fused' and a config "
                "the megakernel covers (algorithms.supports_fused)")

        def lane_step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
            out, t, a_seq, new_state = alg.fused_dehaze_lanes(
                frames, frame_ids, state, cfg)
            return DehazeOutput(out, t, a_seq.to(out.dtype), new_state)
        return lane_step

    if not _fused_covers(cfg):
        return _make_staged_step(cfg, associative=associative, lanes=True)

    # A fused config with the lane-native kernel forced off: the
    # megakernel's single-stream view, lane by lane.
    single = _make_single_step(cfg, associative=associative)

    def per_lane_step(frames, frame_ids, state: AtmoState) -> DehazeOutput:
        outs = [single(frames[i], frame_ids[i], get_lane_state(state, i))
                for i in range(frames.shape[0])]
        return DehazeOutput(
            frames=torch.stack([o.frames for o in outs]),
            transmission=torch.stack([o.transmission for o in outs]),
            atmo_light=torch.stack([o.atmo_light for o in outs]),
            state=pack_atmo_states([o.state for o in outs]))
    return per_lane_step


def make_multi_stream_step(cfg: DehazeConfig, associative: bool = True,
                           lane_native: Optional[bool] = None, *,
                           device: DeviceLike = None):
    """``step(frames (L,B,H,W,3), frame_ids (L,B), state) ->
    DehazeOutput`` with a leading lane axis: :func:`make_step` with the
    lane-batched placement. Padding lanes (ids -1 everywhere) pass their
    state through untouched."""
    return make_step(cfg, PlacementSpec.lane_batched(), device=device,
                     associative=associative, lane_native=lane_native)


__all__ = ["DehazeOutput", "PlacementSpec", "resolve_device", "make_step",
           "make_dehaze_step", "make_multi_stream_step",
           "resolve_lane_native"]
