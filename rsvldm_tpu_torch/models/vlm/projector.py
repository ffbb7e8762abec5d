"""Multimodal projectors (rsvldm_tpu/models/vlm/projector.py): vision
features -> the decoder's embedding width, in the reference's module
layouts so that `mm_projector.*` loads as it is.

`MLPProjector(in, out, depth)` is mlp{depth}x_gelu: Linear(in -> out), then
depth - 1 times exact GELU and Linear(out -> out), as an nn.Sequential
(`mm_projector.{0, 2, 4, ...}`). `build_projector` dispatches on the
reference's names: `linear` (one nn.Linear, `mm_projector.{weight,bias}`),
`mlpNx_gelu`, `pooler` (`PoolerProjector`) and `identity`.
"""

from __future__ import annotations

import re

import torch
from torch import nn


class MLPProjector(nn.Sequential):
    def __init__(self, in_dim: int = 1024, out_dim: int = 4096, depth: int = 2):
        layers = [nn.Linear(in_dim, out_dim)]
        for _ in range(1, depth):
            layers += [nn.GELU(), nn.Linear(out_dim, out_dim)]
        super().__init__(*layers)


class PoolerProjector(nn.Module):
    """A 2x2 stride-2 conv over the patch grid, then GELU and Linear (JAX
    PoolerProjector; names `conv_pool`, `proj.1`): [N, hw*hw, C] ->
    [N, (hw/2)^2, out_dim]."""

    def __init__(self, in_dim: int = 1024, out_dim: int = 4096, hw: int = 24):
        super().__init__()
        self.hw = hw
        self.conv_pool = nn.Conv2d(in_dim, out_dim, 2, stride=2)
        self.proj = nn.Sequential(nn.GELU(), nn.Linear(out_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c = x.shape
        if t != self.hw * self.hw:
            raise ValueError(f"PoolerProjector: {t} tokens, expected "
                             f"{self.hw}^2")
        g = x.transpose(1, 2).reshape(n, c, self.hw, self.hw)
        g = self.conv_pool(g).flatten(2).transpose(1, 2)
        return self.proj(g)


def build_projector(projector_type: str, in_dim: int = 1024,
                    out_dim: int = 4096, **kw) -> nn.Module:
    """The reference's projector dispatch (JAX `build_projector`)."""
    if projector_type == "linear":
        return nn.Linear(in_dim, out_dim)
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return MLPProjector(in_dim, out_dim, int(m.group(1)))
    if projector_type == "pooler":
        return PoolerProjector(in_dim, out_dim, **kw)
    if projector_type == "identity":
        return nn.Identity()
    raise ValueError(f"Unknown projector type: {projector_type}")
