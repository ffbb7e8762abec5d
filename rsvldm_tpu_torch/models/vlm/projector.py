"""Multimodal projector (rsvldm_tpu/models/vlm/projector.py): mlp2x_gelu,
Linear(in -> out), exact GELU, Linear(out -> out). As an nn.Sequential its
parameter names are the reference's `mm_projector.{0,2}.{weight,bias}`."""

from __future__ import annotations

from torch import nn


class MLPProjector(nn.Sequential):
    def __init__(self, in_dim: int = 1024, out_dim: int = 4096):
        super().__init__(nn.Linear(in_dim, out_dim), nn.GELU(),
                         nn.Linear(out_dim, out_dim))
