"""Learning-rate multipliers (rsvldm_tpu/training/lr_schedule.py, the
reference sgm/lr_scheduler.py): step -> factor functions in float32 numpy,
for torch.optim.lr_scheduler.LambdaLR or a loop of one's own."""

from __future__ import annotations

import math

import numpy as np


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                         lr_start: float, max_decay_steps: int):
    """One cycle: linear warmup from lr_start to lr_max, then cosine decay
    to lr_min at max_decay_steps."""

    def sched(step):
        step = np.asarray(step, np.float32)
        warm = lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        t = np.clip((step - warm_up_steps)
                    / max(max_decay_steps - warm_up_steps, 1), 0.0, 1.0)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1 + np.cos(t * math.pi))
        return np.where(step < warm_up_steps, warm, cos).astype(np.float32)

    return sched


def lambda_warmup_cosine2(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """Several cycles, each a warmup to f_max[c] then a cosine to f_min[c];
    past the last cycle f_min[-1]."""
    cum = np.cumsum([0] + list(cycle_lengths))

    def sched(step):
        step = np.asarray(step, np.float32)
        out = np.zeros_like(step)
        done = np.zeros(step.shape, bool)
        for c in range(len(cycle_lengths)):
            in_cycle = (step >= cum[c]) & (step < cum[c + 1]) & ~done
            local = step - cum[c]
            warm = f_start[c] + (f_max[c] - f_start[c]) * local \
                / max(warm_up_steps[c], 1)
            t = np.clip((local - warm_up_steps[c])
                        / max(cycle_lengths[c] - warm_up_steps[c], 1), 0.0, 1.0)
            cos = f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1 + np.cos(t * math.pi))
            val = np.where(local < warm_up_steps[c], warm, cos)
            out = np.where(in_cycle, val, out)
            done = done | in_cycle
        return np.where(done, out, f_min[-1]).astype(np.float32)

    return sched
