"""Learning-rate schedule (port of `gaussianavatars_tpu/utils/schedules.py`;
reference utils/general_utils.py:29-62): log-linear decay with an optional
sine-eased delay, evaluated on the host."""

from __future__ import annotations

import numpy as np


def expon_lr(step, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000):
    """The schedule at `step` (scalar or array; numpy float64)."""
    step = np.asarray(step, dtype=np.float64)
    if lr_init == 0.0 and lr_final == 0.0:
        return np.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0.0, 1.0)
    log_lerp = np.exp(np.log(lr_init) * (1.0 - t) + np.log(lr_final) * t)
    return np.where(step < 0, 0.0, delay_rate * log_lerp)
