"""Optimizer and learning-rate schedule, held against ``repro/optim``."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     apply, clip_by_global_norm, global_norm,
                                     init)
from repro_torch.optim.schedule import ScheduleConfig, lr_at  # noqa: F401
