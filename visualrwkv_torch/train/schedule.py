"""Learning-rate and weight-decay schedules. Counterpart of
``visualrwkv_tpu/train/schedule.py``: cosine decay with linear warm-up,

- ``progress = clip((step - warmup + 1) / (total - warmup), 0, 1)``
- ``lr = lr_final + (lr_init - lr_final) * 0.5 * (1 + cos(pi * progress))``
- during warm-up ``lr *= 0.1 + 0.9 * step / warmup``
- weight decay: interpolation in log space toward ``weight_decay_final``

as plain Python functions of the integer step, evaluated in float32 (numpy)
so that they give the numbers of the JAX functions.
"""

from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def cosine_warmup_lr(step: int, lr_init: float, lr_final: float, warmup_steps: int,
                     total_steps: int) -> float:
    step = _f32(step)
    w = max(warmup_steps, 0)
    if lr_final == lr_init or total_steps <= 0:
        lr = _f32(lr_init)
    else:
        denom = max(total_steps - w, 1)
        progress = np.clip((step - _f32(w) + _f32(1)) / _f32(denom), _f32(0), _f32(1))
        cosine = np.maximum(_f32(0), _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * progress)))
        lr = _f32(lr_final) + _f32(lr_init - lr_final) * cosine
    if w > 0 and step < w:
        lr = lr * (_f32(0.1) + _f32(0.9) * step / _f32(w))
    return float(lr)


def wd_schedule(step: int, weight_decay: float, weight_decay_final: float, warmup_steps: int,
                total_steps: int) -> float:
    if weight_decay_final <= 0 or weight_decay <= 0:
        return float(_f32(weight_decay))
    denom = max(total_steps - max(warmup_steps, 0), 1)
    progress = np.clip((_f32(step) - _f32(warmup_steps) + _f32(1)) / _f32(denom), _f32(0), _f32(1))
    return float(_f32(weight_decay) * np.exp(_f32(math.log(weight_decay_final / weight_decay)) * progress))
