"""LR schedule (torch counterpart of surf_tpu/utils/scheduler.py): linear
warmup 0.1 -> 1 over ``warmup`` epochs, then cosine down to ``alpha`` at
``total_steps`` epochs.  The returned callable maps a (fractional) epoch
to an LR multiplier, the reference's LambdaLR lambda."""

from __future__ import annotations

import numpy as np


def warmup_cosine(total_steps, warmup=0.2, alpha=0.1):
    def scale(step):
        step = np.float32(step)
        if step < warmup:
            return float(np.float32(0.1) + np.float32(0.9) * step / np.float32(warmup))
        cos = (np.cos(np.float32(np.pi) * (step - np.float32(warmup))
                      / np.float32(total_steps - warmup)) + np.float32(1.0)) \
            * np.float32(0.5) * np.float32(1 - alpha) + np.float32(alpha)
        return float(np.float32(cos))
    return scale
