"""Fault-tolerant checkpointing: atomic, manifest-driven, async-capable.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, written to a temp dir
and atomically renamed, so a crash mid-write never leaves a readable but
corrupt checkpoint. ``keep`` old checkpoints are retained for rollback.
``AsyncCheckpointer`` moves serialization off the training critical path
(the device-to-host copy happens synchronously, for consistency; the file
I/O happens in a background thread).

The layout and the leaf order are the JAX package's (``leaf_<i>`` in
``jax.tree_util`` order: dicts by sorted key, :mod:`repro_torch.tree`), so
a checkpoint written by either package loads in the other. A bfloat16
leaf is stored as numpy's 2-byte void (``|V2``) holding its bit
patterns, which is what ``np.savez`` makes of a JAX bfloat16 array; the
loader reads such a leaf back into a ``torch.bfloat16`` ``like`` leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as the numpy array the checkpoint stores (a copy for a
    tensor, also on the CPU, so a later in-place update of the tensor
    does not reach an asynchronous save)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view("V2")
        return t.numpy().copy()
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, like: Any) -> Any:
    """A stored array as ``like``'s leaf: a tensor of ``like``'s dtype on
    its device, or the array itself where ``like`` is not a tensor."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"a {arr.dtype} leaf restores only into "
                             f"bfloat16, not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def save_pytree(path: str, tree: Any, extra: Optional[dict] = None) -> None:
    """Atomically save a pytree of tensors or arrays + JSON-serializable
    extras."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    host_leaves = [_to_host(l) for l in leaves]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": l for i, l in enumerate(host_leaves)})
    manifest = {
        "treedef": str(treedef),
        "n_leaves": len(host_leaves),
        "extra": extra or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (shape/dtype authority):
    each leaf on the device and in the dtype of ``like``'s leaf."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    out = []
    for r, l in zip(restored, leaves):
        if r.shape != tuple(l.shape):
            raise ValueError(f"leaf shape {r.shape} != {tuple(l.shape)}")
        out.append(_from_host(r, l))
    return tree_unflatten(treedef, out), manifest["extra"]


class CheckpointManager:
    """step-indexed checkpoints with retention + latest-resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        path = self._step_dir(step)
        save_pytree(path, tree, extra)
        self._gc()
        return path

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, dict, int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree, extra = load_pytree(self._step_dir(step), like)
        return tree, extra, step

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (the device copy is eager)."""

    def __init__(self, manager: CheckpointManager):
        self._mgr = manager
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        # Materialize on the host NOW (consistency point), write in the
        # background.
        host_tree = tree_map(_to_host, tree)

        def work():
            try:
                self._mgr.save(step, host_tree, extra)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
