"""GroupNorm and LayerNorm with fp32 statistics: the port's ops/norm.py
without its tiled-VAE collective mode, which the timed path does not use.
Epsilons by site: 1e-6 in the VAE and the SpatialTransformer, 1e-5 in the
SDXL ResBlock, ZeroSFT and ZeroCrossAttn."""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


class GroupNorm32(nn.Module):
    """32-group GroupNorm over NCHW (or [N, C, ...]) with fp32 statistics.
    Groups = gcd(num_groups, C)."""

    def __init__(self, channels: int, eps: float = 1e-6, num_groups: int = 32):
        super().__init__()
        self.num_groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward_fp32(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)

    def forward(self, x):
        return self.forward_fp32(x).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last dim in fp32; returns fp32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)
