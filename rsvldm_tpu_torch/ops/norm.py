"""GroupNorm and LayerNorm with fp32 statistics (rsvldm_tpu/ops/norm.py).

Parameter names follow torch (`weight`, `bias`) so reference checkpoints load
as they are. Statistics are taken in fp32 and the result is cast back to the
input's dtype, as the JAX GroupNorm32 does. Epsilons by site: 1e-6 in the
VAE and the SpatialTransformer, 1e-5 in the SDXL ResBlock, ZeroSFT and
ZeroCrossAttn.

Tile-collective mode (the tiled VAE, models/vae/tiled.py): inside
`tile_collective_gn()`, GroupNorm32's mean and variance also pool over the
leading tile axis, in fp32 and in two passes, as JAX's reduction over
(tile, H, W, channels of the group) does, so that every tile is normalised
with the statistics of all of them, halos and overlaps included.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn
import torch.nn.functional as F

# per thread / task, so a tiled call does not switch another caller's norms
_TILE_COLLECTIVE = contextvars.ContextVar("tile_collective_gn", default=False)


@contextlib.contextmanager
def tile_collective_gn():
    """Within it, every GroupNorm32 pools its statistics over the leading
    (tile) axis as well."""
    token = _TILE_COLLECTIVE.set(True)
    try:
        yield
    finally:
        _TILE_COLLECTIVE.reset(token)


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
        if _TILE_COLLECTIVE.get():
            return self._collective_fp32(x)
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)

    def _collective_fp32(self, x):
        """Statistics over (tile, channels of the group, spatial), two-pass
        in fp32 (JAX GroupNorm32 with the tile axis in its reduction). At
        most two fp32 copies of x live at once: the tiles of a 2048^2
        image hold several GB each."""
        n, c = x.shape[:2]
        xg = x.float().reshape(n, self.num_groups, c // self.num_groups, -1)
        dims = (0, 2, 3)
        d = xg - xg.mean(dim=dims, keepdim=True)
        del xg
        var = d.square().mean(dim=dims, keepdim=True)
        y = d.mul_(torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return y.mul_(self.weight.float().reshape(shape)).add_(
            self.bias.float().reshape(shape))

    def forward(self, x):
        return self.forward_fp32(x).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm over the last dim in fp32; returns fp32, as flax
    nn.LayerNorm(dtype=float32) does. The next projection casts."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)
