"""Learning-rate schedule: cosine annealing with warm restarts (SGDR), as a
plain function of the optimizer step.

Counterpart of ``admmnet_tpu/train/schedules.py``, which joins optax cosine
decays: cycle k spans t0 * t_mult^k epochs; within a cycle that starts at
step b and spans d steps, lr(step) = eta_min + (base - eta_min) *
(1 + cos(pi * min(step - b, d) / d)) / 2, in optax's float32 arithmetic.
The optimizer uses lr(count) with count the number of updates made before
this one, as optax does.
"""

from __future__ import annotations

import math

import numpy as np


def sgdr_schedule(base_lr: float, steps_per_epoch: int, total_epochs: int,
                  t0_epochs: int = 10, t_mult: int = 2, eta_min: float = 1e-6):
    """lr(step) of cosine warm restarts; each cycle k spans t0 * t_mult^k
    epochs.  The returned function takes an int and returns a float."""
    starts, lengths = [], []
    start, cycle = 0, t0_epochs
    while start < total_epochs:
        starts.append(start * steps_per_epoch)
        lengths.append(max(1, cycle * steps_per_epoch))
        start += cycle
        cycle *= t_mult
    alpha = np.float32(eta_min / base_lr)
    one_minus_alpha = np.float32(1.0 - eta_min / base_lr)
    base = np.float32(base_lr)

    def lr(step: int) -> float:
        k = 0
        while k + 1 < len(starts) and step >= starts[k + 1]:
            k += 1
        count = np.float32(min(max(step - starts[k], 0), lengths[k]))
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(
            np.float32(math.pi) * count / np.float32(lengths[k]), dtype=np.float32))
        decayed = one_minus_alpha * cosine + alpha
        return float(base * decayed)

    return lr
