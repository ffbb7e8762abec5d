"""Noise schedules, DDPM buffer tables and sigma discretizations
(rsvldm_tpu/diffusion/schedules.py). Tables are built in float64 numpy and
stored as float32 tensors, as the JAX package does."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _warmup_beta(linear_start: float, linear_end: float, n_timestep: int,
                 warmup_frac: float) -> np.ndarray:
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(linear_start, linear_end, warmup_time,
                                      dtype=np.float64)
    return betas


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule table in float64."""
    if schedule == "quad":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, None, 0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class DDPMBuffers:
    """Alpha-cumprod tables of the SR3 ancestral sampler, float32 [T]
    (sqrt_alphas_cumprod_prev is [T+1])."""
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def ddpm_buffers(betas: np.ndarray) -> DDPMBuffers:
    """Posterior/forward tables from a beta schedule (float64 math)."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))
    return DDPMBuffers(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod_prev=f32(np.sqrt(np.append(1.0, alphas_cumprod))),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
    )


def equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """Roughly-equally-spaced timestep subset, ascending."""
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def sd_linear_betas(n_timestep: int, linear_start: float = 0.00085,
                    linear_end: float = 0.0120) -> np.ndarray:
    """Stable-Diffusion 'linear' schedule: linspace in sqrt-space, squared."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def legacy_ddpm_sigmas(n: int, linear_start: float = 0.00085, linear_end: float = 0.0120,
                       num_timesteps: int = 1000, do_append_zero: bool = True,
                       flip: bool = False) -> torch.Tensor:
    """SDXL LegacyDDPM sigma table, descending with an appended 0 by default;
    sigma_t = sqrt((1 - acp_t) / acp_t) on n roughly-equally-spaced steps.
    float32, on the CPU."""
    betas = sd_linear_betas(num_timesteps, linear_start, linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    if n < num_timesteps:
        alphas_cumprod = alphas_cumprod[equally_spaced_steps(n, num_timesteps)]
    elif n > num_timesteps:
        raise ValueError(f"n={n} > num_timesteps={num_timesteps}")
    sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod).astype(np.float32)
    sigmas = sigmas[::-1]
    if do_append_zero:
        sigmas = np.append(sigmas, 0.0).astype(np.float32)
    if flip:
        sigmas = sigmas[::-1]
    return torch.as_tensor(np.ascontiguousarray(sigmas))


def sigma_to_idx(sigma: torch.Tensor, sigma_table_asc: torch.Tensor) -> torch.Tensor:
    """Nearest index of an ascending sigma table: argmin |sigma - table|."""
    dists = (sigma[..., None] - sigma_table_asc[None, ...]).abs()
    return dists.argmin(dim=-1)
