"""Declarative placement of the serving batch, PyTorch port.

The reference's :class:`PlacementSpec` maps every batch axis onto mesh
axes, and ``core.pipeline.make_step(cfg, placement, mesh)`` realizes it:

  batch axis          mesh axes
  ------------------  -------------------------------------------------
  lane  (L)           ``lane_axis``    (lanes over "data": each rank whole lanes)
  frame (B)           ``batch_axes``   (data-parallel frames)
  height (H)          ``height_axis``  (halo-exchanged spatial shard)
  width  (W)          ``width_axis``   (halo-exchanged spatial shard)
  EMA / AtmoState     lane rows co-placed with their lanes, otherwise
                      replicated

The port realizes the placements without a mesh (``single()``,
``lane_batched()``) and the sharded ones (``frame_sharded()``,
``lane_sharded()``) over a ``torch.distributed`` device mesh
(``launch.mesh.make_host_mesh``, or any mesh with the named axes). A height
or width axis of size > 1 splits each frame into tiles whose halos are
exchanged over that axis's process group (``core.spatial``); of size 1 it
changes nothing. ``n_hosts`` sizes the fleet tier (``stream.fleet``),
which schedules hosts above the step: the step itself does not depend on
it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Where every axis of the serving batch lives (frozen, hashable: it
    keys the serving step cache).

    ``lanes`` declares a leading lane axis (``(L, B, ...)``);
    ``lane_axis`` shards it over a mesh axis, each rank owning whole lanes,
    so the per-lane EMA scans need no collective. ``batch_axes`` shards the
    frame axis (mutually exclusive with lanes). ``height_axis`` /
    ``width_axis`` shard the image plane. ``n_hosts`` sizes the fleet
    tier."""
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
        if self.lane_axis is not None and not self.lanes:
            raise ValueError(f"lane_axis={self.lane_axis!r} requires lanes=True")
        if self.lanes and self.batch_axes:
            raise ValueError(
                "lane-batched placements do not shard the frame axis (each "
                "lane's batch stays on its rank so its EMA scan is causal); "
                f"got batch_axes={self.batch_axes!r}")
        named = self.mesh_axes
        if len(set(named)) != len(named):
            raise ValueError(f"mesh axes must be distinct, got {named}")
        return self

    @property
    def mesh_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in batch-axis order."""
        return tuple(ax for ax in ((self.lane_axis,) + self.batch_axes
                                   + (self.height_axis, self.width_axis))
                     if ax is not None)

    @property
    def sharded(self) -> bool:
        """Does realizing this placement need a mesh?"""
        return bool(self.mesh_axes)

    @classmethod
    def single(cls) -> "PlacementSpec":
        """One stream's frame batch on one device."""
        return cls()

    @classmethod
    def lane_batched(cls, n_hosts: int = 1) -> "PlacementSpec":
        """L streams on a leading lane axis, one device."""
        return cls(lanes=True, n_hosts=n_hosts).validate()

    @classmethod
    def lane_sharded(cls, lane_axis: str = "data",
                     height_axis: Optional[str] = None,
                     width_axis: Optional[str] = None,
                     n_hosts: int = 1) -> "PlacementSpec":
        """Lanes over the data mesh axis: each rank serves whole lanes."""
        return cls(lanes=True, lane_axis=lane_axis, height_axis=height_axis,
                   width_axis=width_axis, n_hosts=n_hosts).validate()

    @classmethod
    def frame_sharded(cls, batch_axes: Tuple[str, ...] = ("data",),
                      height_axis: Optional[str] = "model",
                      width_axis: Optional[str] = None) -> "PlacementSpec":
        """One stream's frames over the data axes (the reference's
        production placement, with height over the model axis)."""
        return cls(batch_axes=tuple(batch_axes or ()),
                   height_axis=height_axis, width_axis=width_axis).validate()


__all__ = ["PlacementSpec"]
