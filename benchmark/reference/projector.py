"""Multimodal projectors (rsvldm_tpu/models/vlm/projector.py): vision
features -> the decoder's embedding width, in the reference's module
layouts so that `mm_projector.*` loads as it is.

`MLPProjector(in, out, depth)` is mlp{depth}x_gelu: Linear(in -> out), then
depth - 1 times exact GELU and Linear(out -> out), as an nn.Sequential
(`mm_projector.{0, 2, 4, ...}`).
"""

from __future__ import annotations

import torch
from torch import nn


class MLPProjector(nn.Sequential):
    def __init__(self, in_dim: int = 1024, out_dim: int = 4096, depth: int = 2):
        layers = [nn.Linear(in_dim, out_dim)]
        for _ in range(1, depth):
            layers += [nn.GELU(), nn.Linear(out_dim, out_dim)]
        super().__init__(*layers)
