"""Optimizers and learning-rate schedules (plain torch, no torch.optim)."""
from repro_torch.optim.adamw import (  # noqa: F401
    Optimizer, adamw, clip_by_global_norm, global_norm, is_factored_leaf,
    scalable_adamw)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
