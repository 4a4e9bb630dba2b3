"""LR schedules (port of clipbert_tpu/train/sched.py; reference
`src/optimization/sched.py`).

Linear warmup + decay (:14-17), invsqrt / noam (:8-11), multi_step
(:20-25) and constant, floored at 1e-8 (:44-46). The JAX functions
evaluate inside the jitted update from the step counter in fp32; here they
run on the host once a step, in numpy float32 with the same operations, and
return a float32 the update takes as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

f32 = np.float32


def warmup_linear(step, warmup_step, tot_step) -> np.float32:
    step = f32(step)
    warm = max(f32(warmup_step), f32(1.0))
    tot = f32(tot_step)
    if step < warm:
        return f32(step / warm)
    return max(f32(0.0), f32((tot - step) / max(f32(tot - warm), f32(1.0))))


def noam(step, warmup_step) -> np.float32:
    step = f32(step)
    warm = max(f32(warmup_step), f32(1.0))
    if step <= warm:
        return f32(step / warm)
    return f32(np.sqrt(warm) * rsqrt(step))


def rsqrt(x) -> np.float32:
    return f32(f32(1.0) / np.sqrt(max(f32(x), f32(1e-20))))


def multi_step(n_epoch, milestones: Sequence[int],
               gamma: float = 0.5) -> np.float32:
    """gamma**(#milestones passed); gamma**(len+1) beyond the last one,
    the reference's fall-through exponent."""
    n_epoch = f32(n_epoch)
    ms = sorted(milestones)
    out = f32(float(gamma) ** (len(ms) + 1))
    for i in reversed(range(len(ms))):
        if n_epoch < ms[i]:
            out = f32(gamma ** i)
    return out


def get_lr(global_step, decay: str, learning_rate: float,
           num_train_steps: int, warmup_ratio: float = 0.1,
           decay_epochs: Optional[Sequence[int]] = None,
           multi_step_epoch=None) -> np.float32:
    warmup_steps = int(warmup_ratio * num_train_steps)
    if decay == "linear":
        lr = f32(learning_rate) * warmup_linear(global_step, warmup_steps,
                                                num_train_steps)
    elif decay == "invsqrt":
        lr = f32(learning_rate) * noam(global_step, warmup_steps)
    elif decay == "constant":
        lr = f32(learning_rate)
    elif decay == "multi_step":
        if multi_step_epoch is None:
            raise ValueError("multi_step decay needs the epoch")
        lr = f32(learning_rate) * multi_step(multi_step_epoch,
                                             decay_epochs or [])
    else:
        raise ValueError(f"unknown decay {decay}")
    return max(f32(lr), f32(1e-8))    # safeguard floor (sched.py:44-46)
