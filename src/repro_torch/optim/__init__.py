"""Optimizers and learning-rate schedules (``repro/optim``)."""
from repro_torch.optim.optimizers import Optimizer, adamw, multistep_lr, sgd  # noqa: F401
