"""Diffusion training loss of the SDXL stage (rsvldm_tpu/training/
losses.py, the reference StandardDiffusionLoss): a sigma drawn per sample
(EDM lognormal or a uniform index of the LegacyDDPM table), x0 noised by
sigma * eps, the preconditioned denoiser's output weighted by w(sigma)
(eps: sigma^-2, unit: 1) in an L2 or L1 mean. The draws are JAX's of a
utils/prng key (default PRNGKey(0)), in JAX's order: split into the
sigma's key and the noise's; they may also be given."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..diffusion.schedules import legacy_ddpm_sigmas
from ..utils import prng


def _key(key):
    return prng.key(0) if key is None else key


def edm_sigma_sampling(n: int, p_mean: float = -1.2, p_std: float = 1.2,
                       key: prng.Key | None = None, device="cpu",
                       normal: torch.Tensor | None = None):
    """exp(p_mean + p_std * N(0, 1)), [n]: JAX's normal(key, (n,)) unless
    `normal` is given."""
    if normal is None:
        normal = prng.normal(_key(key), (n,), device=device)
    return torch.exp(p_mean + p_std * normal)


def discrete_sigma_sampling(n: int, num_idx: int = 1000,
                            sigmas: torch.Tensor | None = None,
                            key: prng.Key | None = None, device="cpu",
                            idx: torch.Tensor | None = None):
    """sigmas[U{0..num_idx-1}] over the ascending LegacyDDPM table, [n]:
    JAX's randint(key, (n,), 0, num_idx) unless `idx` is given."""
    if sigmas is None:
        sigmas = legacy_ddpm_sigmas(num_idx, do_append_zero=False, flip=True)
    if idx is None:
        idx = prng.randint(_key(key), (n,), 0, num_idx, device)
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
                            key: prng.Key | None = None):
    """mean_b [w(sigma) * mean_pixels (D(x0 + sigma * eps, sigma) - x0)^2]
    (or |.| for l1). denoise_fn(x_noised, sigma [N]) -> denoised; sigma
    [N] and noise (x0's shape, JAX's NHWC, and dtype) are drawn from
    split(key) unless given."""
    n, dev = x0.shape[0], x0.device
    k_s, k_n = prng.split(_key(key))
    if sigma is None:
        sigma = (edm_sigma_sampling(n, key=k_s, device=dev)
                 if cfg.sigma_sampler == "edm"
                 else discrete_sigma_sampling(n, key=k_s, device=dev))
    if noise is None:
        noise = prng.normal(k_n, tuple(x0.shape), x0.dtype, dev)
    s4 = sigma.reshape(-1, 1, 1, 1)
    pred = denoise_fn(x0 + s4 * noise, sigma)
    w = eps_weighting(s4) if cfg.weighting == "eps" else unit_weighting(s4)
    err = (pred - x0) ** 2 if cfg.loss_type == "l2" else (pred - x0).abs()
    return (w * err).mean(dim=(1, 2, 3)).mean()
