"""Optimizers returning additive updates (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    OptState,
    adam,
    apply_updates,
    make,
    nesterov,
    sgd,
)
