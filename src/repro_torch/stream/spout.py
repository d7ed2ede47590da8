"""The spout (paper §3.2 layer 1): frame source, id assignment, batching."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

_WIRE = (torch.uint8, torch.bfloat16, torch.float32)


def wire_frame(f) -> torch.Tensor:
    """One frame as a CPU tensor in its wire dtype: uint8, bfloat16 and
    float32 pass through (a numpy bfloat16 array is reinterpreted bit for
    bit), anything else becomes float32."""
    if isinstance(f, torch.Tensor):
        t = f.detach().cpu()
    else:
        arr = np.asarray(f)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(
                np.ascontiguousarray(arr).view(np.uint16).copy()
            ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if t.dtype in _WIRE else t.to(torch.float32)


@dataclasses.dataclass
class FrameBatch:
    frames: torch.Tensor     # (B, H, W, 3) wire dtype: uint8 | bf16 | f32
    frame_ids: torch.Tensor  # (B,) int32: consecutive ids, then -1 padding
    n_valid: int             # trailing frames may be padding on the last batch
    stream_id: str = "default"


class Spout:
    """Wraps an iterator of frames, assigns consecutive ids, emits batches.

    The final partial batch is padded by repeating the last frame so the
    step always sees one shape; padding slots carry ``frame_id = -1`` so
    the EMA masks them out (never the future ids of real frames)."""

    def __init__(self, frames, batch: int, start_frame: int = 0,
                 stream_id: str = "default"):
        self._it = iter(frames)
        self._batch = batch
        self._next_id = start_frame
        self._stream_id = stream_id

    def __iter__(self) -> Iterator[FrameBatch]:
        buf = []
        for f in self._it:
            buf.append(wire_frame(f))
            if len(buf) == self._batch:
                yield self._emit(buf)
                buf = []
        if buf:
            yield self._emit(buf)

    def _emit(self, buf) -> FrameBatch:
        n_valid = len(buf)
        while len(buf) < self._batch:
            buf.append(buf[-1])
        ids = torch.full((self._batch,), -1, dtype=torch.int32)
        ids[:n_valid] = torch.arange(self._next_id, self._next_id + n_valid,
                                     dtype=torch.int32)
        self._next_id += n_valid
        return FrameBatch(frames=torch.stack(buf), frame_ids=ids,
                          n_valid=n_valid, stream_id=self._stream_id)
