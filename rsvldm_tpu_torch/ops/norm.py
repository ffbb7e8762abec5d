"""GroupNorm and LayerNorm with fp32 statistics (rsvldm_tpu/ops/norm.py).

Parameter names follow torch (`weight`, `bias`) so reference checkpoints load
as they are. Statistics are taken in fp32 and the result is cast back to the
input's dtype, as the JAX GroupNorm32 does. Epsilons by site: 1e-6 in the
VAE and the SpatialTransformer, 1e-5 in the SDXL ResBlock, ZeroSFT and
ZeroCrossAttn.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


class GroupNorm32(nn.Module):
    """32-group GroupNorm over NCHW (or [N, C, ...]) with fp32 statistics.
    Groups = gcd(num_groups, C), as the JAX module."""

    def __init__(self, channels: int, eps: float = 1e-6, num_groups: int = 32):
        super().__init__()
        self.num_groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward_fp32(self, x):
        """The normalised x in fp32 (flax nn.GroupNorm(dtype=float32))."""
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)

    def forward(self, x):
        return self.forward_fp32(x).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last dim in fp32; returns fp32, as flax
    nn.LayerNorm(dtype=float32) does. The next projection casts."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)
