"""Declarative placement of the serving batch, PyTorch port.

The reference's :class:`PlacementSpec` maps every batch axis (lane,
frame, height, width) onto mesh axes. This port serves one device, so it
realizes the two placements without a mesh: ``single()`` (a ``(B, H, W,
3)`` batch) and ``lane_batched()`` (``(L, B, H, W, 3)``, L streams). A
spec naming any mesh axis, or more than one host, raises
``NotImplementedError``: sharding and the fleet tier are later slices
(ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Where every axis of the serving batch lives (frozen, hashable: it
    keys the serving step cache)."""
    lanes: bool = False
    lane_axis: Optional[str] = None
    batch_axes: Tuple[str, ...] = ()
    height_axis: Optional[str] = None
    width_axis: Optional[str] = None
    n_hosts: int = 1

    def __post_init__(self):
        if not isinstance(self.batch_axes, tuple):
            object.__setattr__(self, "batch_axes", tuple(self.batch_axes))

    def validate(self) -> "PlacementSpec":
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if self.mesh_axes:
            raise NotImplementedError(
                f"mesh-sharded placements ({self.mesh_axes}) are not ported "
                "yet (ROADMAP.md queue A, sharding)")
        if self.n_hosts > 1:
            raise NotImplementedError(
                "multi-host fleet serving is not ported yet (ROADMAP.md "
                "queue A, fleet)")
        return self

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        return tuple(ax for ax in ((self.lane_axis,) + self.batch_axes
                                   + (self.height_axis, self.width_axis))
                     if ax is not None)

    @classmethod
    def single(cls) -> "PlacementSpec":
        """One stream's frame batch on one device."""
        return cls()

    @classmethod
    def lane_batched(cls, n_hosts: int = 1) -> "PlacementSpec":
        """L streams on a leading lane axis, one device."""
        return cls(lanes=True, n_hosts=n_hosts).validate()


__all__ = ["PlacementSpec"]
