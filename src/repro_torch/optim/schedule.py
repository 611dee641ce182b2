"""Learning-rate schedules (pure functions of the step counter), held
against ``repro/optim/schedule.py``.  Computed in float32 on the host, as the
reference computes them in float32 inside its step."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"            # cosine | linear | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1


def lr_at(step, cfg: ScheduleConfig) -> float:
    f32 = np.float32
    s = f32(step)
    peak = f32(cfg.peak_lr)
    warm = peak * np.minimum(f32(1.0), s / f32(max(cfg.warmup_steps, 1)))
    if cfg.kind == "constant":
        return float(warm)
    frac = np.clip((s - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    ratio = f32(cfg.min_ratio)
    if cfg.kind == "linear":
        decay = f32(1.0) - (f32(1.0) - ratio) * frac
    else:  # cosine
        decay = ratio + (f32(1.0) - ratio) * f32(0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * frac))
    return float(warm if s < cfg.warmup_steps else peak * decay)
