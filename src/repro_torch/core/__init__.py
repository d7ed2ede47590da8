"""Component-decomposed dehazing (PyTorch port of ``repro.core``).

- ``config``     — DehazeConfig
- ``env``        — validated ``REPRO_*`` accessors
- ``algorithms`` — the three generic components + DCP/CAP instantiations
- ``normalize``  — cross-frame atmospheric-light EMA normalization (§3.3)
- ``physics``    — the scattering model (Eqs. 1, 2, 8) on tensors
- ``placement``  — single, lane-batched and data-parallel placements
- ``pipeline``   — single-stream, lane-batched and sharded dehaze steps,
                   and the buffer-donation contract (``donation_spec``)
- ``spatial``    — the masked filters of the sharded step
"""
from repro_torch.core.config import DehazeConfig
from repro_torch.core.normalize import (AtmoState, ema_scan,
                                        ema_scan_associative, ema_scan_lanes,
                                        get_lane_state, init_atmo_state,
                                        init_atmo_state_lanes, lane_carry,
                                        pack_atmo_states, set_lane_state,
                                        state_from_lane_carry,
                                        unpack_atmo_states)
from repro_torch.core.pipeline import (DehazeOutput, donation_spec,
                                       make_dehaze_step,
                                       make_multi_stream_step,
                                       make_sharded_dehaze_step, make_step,
                                       resolve_device, resolve_lane_native)
from repro_torch.core.placement import PlacementSpec

__all__ = [
    "DehazeConfig", "AtmoState", "ema_scan", "ema_scan_associative",
    "ema_scan_lanes", "init_atmo_state", "init_atmo_state_lanes",
    "lane_carry", "pack_atmo_states", "unpack_atmo_states",
    "state_from_lane_carry", "get_lane_state", "set_lane_state",
    "DehazeOutput", "PlacementSpec", "make_step", "make_dehaze_step",
    "donation_spec",
    "make_multi_stream_step", "make_sharded_dehaze_step", "resolve_device",
    "resolve_lane_native",
]
