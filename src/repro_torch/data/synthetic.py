"""Synthetic input pipelines for the model zoo + prefetch to the device.

Deterministic, seeded, and cheap: LM token streams, labeled image batches,
and diffusion (latent, timestep, conditioning) tuples. The streams are
numpy code, the port's copy of the JAX package's ``data/synthetic.py``:
given the same seed they yield bit-equal arrays. A double-buffered
host-to-device prefetcher overlaps input generation and transfer with
compute, the training-loop analogue of the paper's spout -> worker
overlap.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.pipeline import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map


class TokenStream:
    """Endless (batch, seq) int32 token batches with next-token labels."""

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            # Strongly learnable Markov stream: with p=0.85 the next token
            # is (prev + 1) mod V, else uniform, so the loss drops toward
            # ~0.15 ln V + H(0.85) within a few hundred steps.
            n = self.seq_len + 1
            toks = np.empty((self.batch, n), np.int64)
            toks[:, 0] = self._rng.integers(0, self.vocab, self.batch)
            follow = self._rng.random((self.batch, n)) < 0.85
            rand = self._rng.integers(0, self.vocab, (self.batch, n))
            for i in range(1, n):
                toks[:, i] = np.where(follow[:, i],
                                      (toks[:, i - 1] + 1) % self.vocab,
                                      rand[:, i])
            toks = toks.astype(np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ImageStream:
    """Endless labeled image batches (NHWC float32 in [0,1])."""

    def __init__(self, batch: int, height: int, width: int, n_classes: int,
                 channels: int = 3, seed: int = 0):
        self.batch, self.h, self.w, self.c = batch, height, width, channels
        self.n_classes = n_classes
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            labels = self._rng.integers(0, self.n_classes, (self.batch,),
                                        np.int32)
            # Class-dependent mean so a classifier can actually learn.
            mean = (labels[:, None, None, None] % 8).astype(np.float32) / 8.0
            img = np.clip(
                mean + 0.25 * self._rng.standard_normal(
                    (self.batch, self.h, self.w, self.c)).astype(np.float32),
                0.0, 1.0)
            yield {"images": img, "labels": labels}


class DiffusionStream:
    """Endless (latents, timesteps, conditioning) batches for DiT/U-Net."""

    def __init__(self, batch: int, latent_res: int, channels: int,
                 n_classes: int = 1000, ctx_len: int = 0, ctx_dim: int = 0,
                 seed: int = 0):
        self.batch, self.res, self.c = batch, latent_res, channels
        self.n_classes, self.ctx_len, self.ctx_dim = n_classes, ctx_len, ctx_dim
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            out = {
                "latents": self._rng.standard_normal(
                    (self.batch, self.res, self.res, self.c)).astype(np.float32),
                "timesteps": self._rng.integers(
                    0, 1000, (self.batch,), np.int32),
                "labels": self._rng.integers(
                    0, self.n_classes, (self.batch,), np.int32),
            }
            if self.ctx_len:
                out["context"] = self._rng.standard_normal(
                    (self.batch, self.ctx_len, self.ctx_dim)).astype(np.float32)
            yield out


def _to_device(item: Any, device: torch.device, stream):
    """``(item's arrays as tensors on device, ready)``. On CUDA each goes
    from pinned memory on ``stream``, and ``ready`` is an event recorded
    after the copies; elsewhere ``ready`` is None."""
    if device.type != "cuda":
        return tree_map(lambda v: torch.as_tensor(v).to(device), item), None
    with torch.cuda.stream(stream):
        out = tree_map(lambda v: torch.as_tensor(v).pin_memory().to(
            device, non_blocking=True), item)
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def prefetch_to_device(it: Iterator, size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Double-buffered host-to-device prefetch of batches (pytrees of
    arrays): generation and transfer of batch k+1 overlap the compute of
    batch k.

    ``device=None`` means CUDA (``RuntimeError`` without a card; nothing
    falls back to the CPU). On a card a producer thread copies each batch
    from pinned memory on a side stream, and the consumer's current stream
    waits for those copies before it receives the batch; the tensors are
    marked as used on the consumer's stream, so the allocator does not
    reuse them under its work. The iterator ends when ``it`` does."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()

    def producer():
        try:
            for item in it:
                q.put(_to_device(item, dev, side))
        finally:
            q.put(stop)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    while True:
        got = q.get()
        if got is stop:
            return
        item, ready = got
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in tree_leaves(item):
                t.record_stream(consumer)
        yield item
