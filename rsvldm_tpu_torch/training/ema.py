"""Exponential moving average of a model's parameters
(rsvldm_tpu/training/ema.py): the reference LitEma's warmup decay
min((1 + step) / (10 + step), decay), applied from the first update."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]
    step: int = 0


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """A detached copy of `params` (name -> tensor) and step 0."""
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0)


@torch.no_grad()
def ema_update(state: EmaState, new_params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """In place: step + 1, then e = e * d + (1 - d) * p with d the fp32
    decay of that step, as JAX computes it."""
    state.step += 1
    s = np.float32(state.step)
    d = np.minimum((np.float32(1.0) + s) / (np.float32(10.0) + s),
                   np.float32(decay))
    d, one_minus = float(d), float(np.float32(1.0) - d)
    for k, e in state.params.items():
        e.copy_(e * d + one_minus * new_params[k].to(e.dtype))
    return state
