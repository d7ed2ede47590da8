"""Cross-frame atmospheric-light normalization (paper §3.3), PyTorch port.

The paper's update strategy: peers reuse the saved estimate while the
frame distance to the last update is below the period ``l``; at distance
>= l the state refreshes through the EMA ``A_m = λ·A_new + (1−λ)·A_k``
(Eq. 9). Realized as a deterministic causal scan over the frame axis:

  - ``ema_scan``             — a Python loop over frames, any sorted ids
                               (gaps left by dropped frames included);
  - ``ema_scan_associative`` — the same recurrence in its linear (c, d)
                               form for consecutive ids: ``A_i = c_i·A_{i-1}
                               + d_i``, composed directly (PyTorch has no
                               associative scan).

Both take leading lane axes on the candidates, ids and state, so L lanes
scan in the same tensor operations (``ema_scan_lanes``).

**Padding frames** (``frame_id < 0``) never trigger an update, never flip
``initialized``, and carry the running A through; an empty or all-padding
batch passes the state through untouched.

**Lanes.** A lane-batched ``AtmoState`` stacks L streams' states on a
leading axis (``A (L, 3)``, ``last_update (L,)``, ``initialized (L,)``).
``lane_carry``/``state_from_lane_carry`` convert it to and from the
megakernel's ``(L, 3)`` float32 / ``(L, 2)`` int32 carry rows.

State constructors default to the CPU: the state is a few bytes that the
serving tier keeps on the host and the step moves to its device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.ref import ema_step

#: ``last_update`` of a fresh stream (int32, as on the reference).
BOOTSTRAP_ID = -(2 ** 30)


_FIELDS = ("A", "last_update", "initialized")


@dataclasses.dataclass
class AtmoState:
    """Shared atmospheric-light state for one stream (or L lanes)."""
    A: torch.Tensor            # (3,) float32 — current shared estimate A_k
    last_update: torch.Tensor  # ()  int32   — frame id k of the last refresh
    initialized: torch.Tensor  # ()  bool    — False until the first frame

    def to(self, device) -> "AtmoState":
        return AtmoState(A=self.A.to(device),
                         last_update=self.last_update.to(device),
                         initialized=self.initialized.to(device))

    def clone(self) -> "AtmoState":
        return AtmoState(A=self.A.clone(),
                         last_update=self.last_update.clone(),
                         initialized=self.initialized.clone())

    def consume(self) -> None:
        """Mark this state donated (``core.pipeline.make_step(...,
        donate=...)``): the step wrote the new state into its tensors, which
        now belong to the step's ``out.state``; reading a field of this
        object raises ``RuntimeError`` from here on."""
        for name in _FIELDS:
            self.__dict__.pop(name, None)

    def __getattr__(self, name):
        # Reached only where the normal lookup fails: a consumed state.
        if name in _FIELDS:
            raise RuntimeError(
                f"AtmoState.{name} read after the state was donated to a "
                "step; the step's out.state holds the new state")
        raise AttributeError(name)


def init_atmo_state(device="cpu") -> AtmoState:
    """Bootstrap: white atmospheric light until the first estimate lands."""
    return AtmoState(
        A=torch.ones(3, dtype=torch.float32, device=device),
        last_update=torch.tensor(BOOTSTRAP_ID, dtype=torch.int32,
                                 device=device),
        initialized=torch.tensor(False, device=device))


def _state_tensors(state: AtmoState):
    return (state.A.to(torch.float32), state.last_update.to(torch.int32),
            state.initialized.to(torch.bool))


def ema_scan(a_cand: torch.Tensor, frame_ids: torch.Tensor, state: AtmoState,
             period: int, lam: float) -> Tuple[torch.Tensor, AtmoState]:
    """Sequential scan: (..., B, 3) candidates, (..., B) int32 ids (< 0 =
    padding) and a state with the same leading axes -> ((..., B, 3)
    per-frame A, updated state)."""
    a_cand = a_cand.to(torch.float32)
    if a_cand.shape[-2] == 0:
        return a_cand, state
    A, k, inited = _state_tensors(state)
    ids = frame_ids.to(device=a_cand.device, dtype=torch.int32)
    seq = []
    for i in range(a_cand.shape[-2]):
        A, k, inited = ema_step(a_cand[..., i, :], ids[..., i], A, k, inited,
                                period=period, lam=lam)
        seq.append(A)
    return (torch.stack(seq, dim=-2),
            AtmoState(A=A, last_update=k, initialized=inited))


def ema_scan_associative(a_cand: torch.Tensor, frame_ids: torch.Tensor,
                         state: AtmoState, period: int,
                         lam: float) -> Tuple[torch.Tensor, AtmoState]:
    """Consecutive-id path, shaped as :func:`ema_scan`: the linear
    recurrence ``A_i = c_i·A_{i-1} + d_i`` with ``c_i = 1 - λ·m_i`` (0 on
    bootstrap) and ``d_i = λ·m_i·cand_i`` (``cand_i`` on bootstrap),
    composed as ``(c2, d2)∘(c1, d1) = (c2·c1, c2·d1 + d2)`` and applied to
    the entry state once. The update positions ``m_i`` are closed-form: the
    first at ``u0 = max(fid0, k0 + period)`` (``fid0``, the first valid id,
    when uninitialized), then every ``period`` frames. Every index stays on
    the device: nothing here synchronises with the card."""
    a_cand = a_cand.to(torch.float32)
    if a_cand.shape[-2] == 0:
        return a_cand, state
    A0, k0, inited0 = _state_tensors(state)
    ids = frame_ids.to(device=a_cand.device, dtype=torch.int32)
    valid = ids >= 0
    first = torch.argmax(valid.to(torch.int32), dim=-1, keepdim=True)
    fid0 = ids.gather(-1, first)
    u0 = torch.where(inited0[..., None],
                     torch.maximum(fid0, k0[..., None] + period), fid0)
    d = ids - u0
    mask = valid & (d >= 0) & (d % period == 0)
    bootstrap = (~inited0[..., None] & valid
                 & (torch.arange(ids.shape[-1], device=ids.device) == first))
    m = mask.to(torch.float32)[..., None]
    c = torch.where(bootstrap[..., None], torch.zeros_like(m), 1.0 - lam * m)
    d = torch.where(bootstrap[..., None], a_cand, lam * m * a_cand)
    cc, dd = [c[..., 0, :]], [d[..., 0, :]]
    for i in range(1, ids.shape[-1]):
        cc.append(c[..., i, :] * cc[-1])
        dd.append(c[..., i, :] * dd[-1] + d[..., i, :])
    a_seq = (torch.stack(cc, dim=-2) * A0[..., None, :]
             + torch.stack(dd, dim=-2))

    upd = mask | bootstrap
    masked = torch.where(upd, ids, torch.full_like(ids, BOOTSTRAP_ID))
    last = masked.gather(-1, torch.argmax(masked, dim=-1, keepdim=True))
    new_state = AtmoState(
        A=a_seq[..., -1, :],
        last_update=torch.where(upd.any(-1), last[..., 0], k0),
        initialized=inited0 | valid.any(-1))
    return a_seq, new_state


# ---------------------------------------------------------------------------
# Lane-batched state
# ---------------------------------------------------------------------------

def pack_atmo_states(states: Sequence[AtmoState]) -> AtmoState:
    """Stack per-stream states into one lane-batched state (lane axis 0)."""
    return AtmoState(A=torch.stack([s.A for s in states]),
                     last_update=torch.stack([s.last_update for s in states]),
                     initialized=torch.stack([s.initialized for s in states]))


def init_atmo_state_lanes(n_lanes: int, device="cpu") -> AtmoState:
    """``n_lanes`` independent bootstrap states on a leading lane axis,
    made by fills on ``device`` (no host-to-device copy)."""
    return AtmoState(
        A=torch.ones((n_lanes, 3), dtype=torch.float32, device=device),
        last_update=torch.full((n_lanes,), BOOTSTRAP_ID, dtype=torch.int32,
                               device=device),
        initialized=torch.zeros((n_lanes,), dtype=torch.bool, device=device))


def get_lane_state(state: AtmoState, lane: int) -> AtmoState:
    """One lane's (3,)/()/() state (copies: safe to keep after the packed
    state changes)."""
    return AtmoState(A=state.A[lane].clone(),
                     last_update=state.last_update[lane].clone(),
                     initialized=state.initialized[lane].clone())


def unpack_atmo_states(state: AtmoState) -> List[AtmoState]:
    """Inverse of :func:`pack_atmo_states`."""
    return [get_lane_state(state, i) for i in range(state.A.shape[0])]


def set_lane_state(packed: AtmoState, lane: int,
                   state: AtmoState) -> AtmoState:
    """A new lane-batched state with one lane replaced (admission: a new
    stream takes over a free lane). ``packed`` itself is not modified."""
    out = packed.clone()
    # A host state goes up without waiting for the device: CUDA copies a
    # pageable source to staging memory before the call returns.
    for name in _FIELDS:
        dst = getattr(out, name)
        dst[lane] = getattr(state, name).to(dst.device, dst.dtype,
                                            non_blocking=True)
    return out


def repack_lanes(packed: AtmoState, lanes: Sequence[int],
                 n_lanes: int) -> AtmoState:
    """A new ``n_lanes``-lane state on ``packed``'s device whose first
    ``len(lanes)`` rows are ``packed``'s rows ``lanes`` (one gather a
    field, bit-exact) and whose other rows are fresh. The index goes up
    from pinned memory without waiting, so on CUDA nothing synchronises
    with the host; ``packed`` is not modified."""
    dev = packed.A.device
    out = init_atmo_state_lanes(n_lanes, dev)
    if lanes:
        idx = torch.tensor(list(lanes), dtype=torch.int64)
        if dev.type == "cuda":
            idx = idx.pin_memory().to(dev, non_blocking=True)
        for name in _FIELDS:
            getattr(out, name)[:len(lanes)] = \
                getattr(packed, name).index_select(0, idx)
    return out


def lane_carry(state: AtmoState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-batched state -> the megakernel's carry rows ``(carry_f (L, 3)
    float32, carry_i (L, 2) int32 = (last_update, initialized))``."""
    return (state.A.to(torch.float32),
            torch.stack([state.last_update.to(torch.int32),
                         state.initialized.to(torch.int32)], dim=-1))


def state_from_lane_carry(carry_f: torch.Tensor,
                          carry_i: torch.Tensor) -> AtmoState:
    """Inverse of :func:`lane_carry`."""
    return AtmoState(A=carry_f, last_update=carry_i[..., 0],
                     initialized=carry_i[..., 1] != 0)


def ema_scan_lanes(a_cand: torch.Tensor, frame_ids: torch.Tensor,
                   state: AtmoState, period: int, lam: float,
                   associative: bool = True) -> Tuple[torch.Tensor, AtmoState]:
    """Per-lane scans: (L, B, 3) candidates, (L, B) ids, lane-batched state
    -> ((L, B, 3), lane-batched state). Each lane scans its own causal
    chain, all lanes in the same tensor operations; padding lanes (all ids
    < 0) pass through."""
    scan = ema_scan_associative if associative else ema_scan
    return scan(a_cand, frame_ids, state, period, lam)


__all__ = ["AtmoState", "BOOTSTRAP_ID", "init_atmo_state", "ema_scan",
           "ema_scan_associative", "init_atmo_state_lanes",
           "pack_atmo_states", "unpack_atmo_states", "get_lane_state",
           "set_lane_state", "repack_lanes", "lane_carry", "state_from_lane_carry",
           "ema_scan_lanes"]
