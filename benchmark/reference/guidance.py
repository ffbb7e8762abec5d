"""Classifier-free guidance (rsvldm_tpu/diffusion/guidance.py). The uncond
and cond halves run as one batch of 2N, uncond first."""

from __future__ import annotations

import torch

SIGMA_MAX = 14.6146  # LegacyDDPM sigma_max used by LinearCFG


def linear_cfg_scale(sigma, scale: float, scale_min: float | None = None):
    """(scale - scale_min) * sigma / 14.6146 + scale_min."""
    if scale_min is None:
        scale_min = scale
    return (scale - scale_min) * sigma / SIGMA_MAX + scale_min


def apply_cfg(denoised_pair: torch.Tensor, scale) -> torch.Tensor:
    """x_u + scale * (x_c - x_u) over a [2N, ...] batch; scale a number, a
    0-d tensor or one per example [N]."""
    n = denoised_pair.shape[0] // 2
    x_u, x_c = denoised_pair[:n], denoised_pair[n:]
    if isinstance(scale, torch.Tensor) and scale.dim() > 0:
        scale = scale.reshape((-1,) + (1,) * (x_u.dim() - 1))
    return x_u + scale * (x_c - x_u)
