"""Optimizers and learning-rate schedules of the port (the counterpart of
:mod:`repro.optim`): pure functions on trees of tensors."""
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_norm, global_norm,
                                          momentum, sgd)
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["Optimizer", "adamw", "momentum", "sgd", "apply_updates",
           "global_norm", "clip_by_norm", "constant", "cosine",
           "warmup_cosine"]
