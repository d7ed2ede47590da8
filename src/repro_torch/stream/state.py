"""Keyed per-stream state store (paper §3.3 state), PyTorch port.

Holds the shared atmospheric-light state and the frame cursor of every
stream, on the host. This system has no weights: the EMA state and the
cursors are what a restarted server must carry over. The store converts
to and from the numpy pytree the JAX package's
``StreamStateStore.to_pytree()`` returns, so a stream served by the JAX
server continues on the port with the same coherent A trajectory.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.core.normalize import AtmoState, init_atmo_state


def _field(state, name: str):
    """``state.<name>`` or ``state[name]``: the reference's AtmoState with
    numpy leaves, or the dict form :meth:`to_numpy_pytree` writes."""
    return state[name] if isinstance(state, dict) else getattr(state, name)


class StreamStateStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._states: Dict[str, AtmoState] = {}
        self._cursors: Dict[str, int] = {}

    def get(self, stream_id: str) -> AtmoState:
        with self._lock:
            if stream_id not in self._states:
                self._states[stream_id] = init_atmo_state()
                self._cursors[stream_id] = 0
            return self._states[stream_id]

    def update(self, stream_id: str, state: AtmoState, cursor: int) -> None:
        """Store a stream's state (moved to the host) and its cursor."""
        with self._lock:
            self._states[stream_id] = state.to("cpu")
            self._cursors[stream_id] = cursor

    def cursor(self, stream_id: str) -> int:
        with self._lock:
            return self._cursors.get(stream_id, 0)

    # -- checkpoint / hand-over --------------------------------------------

    def to_numpy_pytree(self):
        """``{"keys", "states", "cursors"}`` with each state a dict of numpy
        leaves: ``A`` (3,) float32, ``last_update`` () int32,
        ``initialized`` () bool."""
        with self._lock:
            keys = sorted(self._states)
            states = [{
                "A": self._states[k].A.numpy().astype(np.float32),
                "last_update": np.asarray(
                    self._states[k].last_update.numpy(), np.int32),
                "initialized": np.asarray(
                    self._states[k].initialized.numpy(), bool),
            } for k in keys]
            return {"keys": list(keys), "states": states,
                    "cursors": [self._cursors[k] for k in keys]}

    @classmethod
    def from_jax_pytree(cls, tree) -> "StreamStateStore":
        """Build a store from the reference's ``to_pytree()`` (or from
        :meth:`to_numpy_pytree`)."""
        store = cls()
        for k, s, c in zip(tree["keys"], tree["states"], tree["cursors"]):
            store._states[k] = AtmoState(
                A=torch.tensor(np.asarray(_field(s, "A"), np.float32)),
                last_update=torch.tensor(
                    np.asarray(_field(s, "last_update"), np.int32)),
                initialized=torch.tensor(
                    bool(np.asarray(_field(s, "initialized")))))
            store._cursors[k] = int(c)
        return store
