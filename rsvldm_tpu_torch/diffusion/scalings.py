"""EDM-style denoiser preconditioning (rsvldm_tpu/diffusion/scalings.py)."""

from __future__ import annotations

import torch


def eps_scaling(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) = (1, -sigma, 1/sqrt(sigma^2+1), sigma)."""
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma
