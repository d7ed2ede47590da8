"""Atomic, manifest-driven checkpointing with async writes (the port's
copy of the JAX package's ``checkpoint``; the two read each other's
checkpoints)."""
from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                            CheckpointManager, load_pytree,
                                            save_pytree)

__all__ = ["CheckpointManager", "AsyncCheckpointer", "save_pytree",
           "load_pytree"]
