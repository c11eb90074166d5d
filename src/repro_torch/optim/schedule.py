"""Learning-rate schedules: pure functions of the host step, evaluated in
float32 with the reference's operation order (`repro/optim/schedule.py`)."""
from __future__ import annotations

import math

import numpy as np

f32 = np.float32


def constant(lr):
    return lambda step: f32(lr)


def warmup_cosine(lr, warmup_steps, total_steps, min_lr=0.0):
    def f(step):
        t = f32(step)
        w = min(t / f32(max(warmup_steps, 1)), f32(1.0))
        prog = np.clip((t - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(min_lr) + f32(0.5 * (lr - min_lr)) \
            * (f32(1.0) + np.cos(f32(math.pi) * prog))
        return f32(w * cos)
    return f
