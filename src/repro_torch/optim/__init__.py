"""Optimizers as (init, update) pairs and learning-rate schedules over
dicts of tensors: the port of ``repro.optim``."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    exponential_decay,
    global_norm,
    momentum_sgd,
    sgd,
)
