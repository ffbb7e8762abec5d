"""EDM-style denoiser preconditioning (rsvldm_tpu/diffusion/scalings.py).

Each returns (c_skip, c_out, c_in, c_noise) for a sigma tensor, in its
dtype; the denoiser is D(x, sigma) = c_skip * x + c_out * F(c_in * x, c_noise).
"""

from __future__ import annotations

import torch


def eps_scaling(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) = (1, -sigma, 1/sqrt(sigma^2+1), sigma)."""
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma


def v_scaling(sigma: torch.Tensor):
    """(1/(sigma^2+1), -sigma/sqrt(sigma^2+1), 1/sqrt(sigma^2+1), sigma)."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    return c_skip, c_out, c_in, sigma


def edm_scaling(sigma: torch.Tensor, sigma_data: float = 0.5):
    """Karras et al.'s preconditioning for data of std `sigma_data`;
    c_noise = log(sigma) / 4."""
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / torch.sqrt(sigma ** 2 + sigma_data ** 2)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + sigma_data ** 2)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


SCALINGS = {"eps": eps_scaling, "v": v_scaling, "edm": edm_scaling}
