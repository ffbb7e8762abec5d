"""Diffusion training loss of the SDXL stage (rsvldm_tpu/training/
losses.py, the reference StandardDiffusionLoss): a sigma drawn per sample
(EDM lognormal or a uniform index of the LegacyDDPM table), x0 noised by
sigma * eps, the preconditioned denoiser's output weighted by w(sigma)
(eps: sigma^-2, unit: 1) in an L2 or L1 mean. Draws come from a
torch.Generator unless given."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..diffusion.schedules import legacy_ddpm_sigmas


def edm_sigma_sampling(n: int, p_mean: float = -1.2, p_std: float = 1.2,
                       generator: torch.Generator | None = None,
                       device=None, normal: torch.Tensor | None = None):
    """exp(p_mean + p_std * N(0, 1)), [n]."""
    if normal is None:
        normal = torch.randn((n,), generator=generator, device=device)
    return torch.exp(p_mean + p_std * normal)


def discrete_sigma_sampling(n: int, num_idx: int = 1000,
                            sigmas: torch.Tensor | None = None,
                            generator: torch.Generator | None = None,
                            device=None, idx: torch.Tensor | None = None):
    """sigmas[U{0..num_idx-1}] over the ascending LegacyDDPM table, [n]."""
    if sigmas is None:
        sigmas = legacy_ddpm_sigmas(num_idx, do_append_zero=False, flip=True)
    if idx is None:
        idx = torch.randint(0, num_idx, (n,), generator=generator,
                            device=device)
    return sigmas.to(idx.device)[idx.long()]


def eps_weighting(sigma):
    return sigma ** -2.0


def unit_weighting(sigma):
    return torch.ones_like(sigma)


@dataclasses.dataclass(frozen=True)
class StandardDiffusionLossConfig:
    sigma_sampler: str = "discrete"     # "discrete" | "edm"
    weighting: str = "eps"              # "eps" | "unit"
    loss_type: str = "l2"


def standard_diffusion_loss(denoise_fn: Callable, x0: torch.Tensor,
                            cfg: StandardDiffusionLossConfig =
                            StandardDiffusionLossConfig(),
                            sigma: torch.Tensor | None = None,
                            noise: torch.Tensor | None = None,
                            generator: torch.Generator | None = None):
    """mean_b [w(sigma) * mean_pixels (D(x0 + sigma * eps, sigma) - x0)^2]
    (or |.| for l1). denoise_fn(x_noised, sigma [N]) -> denoised; sigma
    [N] and noise (as x0) are drawn unless given."""
    n, dev = x0.shape[0], x0.device
    if sigma is None:
        sigma = (edm_sigma_sampling(n, generator=generator, device=dev)
                 if cfg.sigma_sampler == "edm"
                 else discrete_sigma_sampling(n, generator=generator,
                                              device=dev))
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=dev,
                            dtype=x0.dtype)
    s4 = sigma.reshape(-1, 1, 1, 1)
    pred = denoise_fn(x0 + s4 * noise, sigma)
    w = eps_weighting(s4) if cfg.weighting == "eps" else unit_weighting(s4)
    err = (pred - x0) ** 2 if cfg.loss_type == "l2" else (pred - x0).abs()
    return (w * err).mean(dim=(1, 2, 3)).mean()
