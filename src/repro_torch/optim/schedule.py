"""Learning-rate schedules (pure functions of the step counter), ported
from ``repro/optim/schedule.py``."""
from __future__ import annotations

import math


def cosine_schedule(step, *, base_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warmup then cosine decay to ``min_ratio * base_lr``."""
    s = float(step)
    warm = min(s / max(warmup_steps, 1), 1.0)
    prog = min(max((s - warmup_steps)
                   / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    decay = min_ratio + (1.0 - min_ratio) * cos
    return base_lr * warm * decay
