"""Optimizers + schedules over the port's pytrees (the port's copy of the
JAX package's ``optim``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "global_norm"]
