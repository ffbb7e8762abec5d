"""SR3 Gaussian diffusion: the ancestral reverse loop
(rsvldm_tpu/models/sr3/diffusion.py: SR3Diffusion.from_schedule, sr3_sample).

The JAX package runs the loop as one lax.scan with noise drawn in-loop; here
it is a Python loop over the model and the noise is an argument, laid out
as the JAX `noise_override` [T+1, N, H, W, 3]: [0] is x_T, [1+i] the
posterior noise of loop step i (zeroed at t = 0).
"""

from __future__ import annotations

import dataclasses

import torch

from ...diffusion.schedules import DDPMBuffers, ddpm_buffers, make_beta_schedule


@dataclasses.dataclass(frozen=True)
class SR3Diffusion:
    """Schedule tables of the sampler; x_0 predictions are clipped to
    [-1, 1], as the reference's default."""
    buffers: DDPMBuffers

    @classmethod
    def from_schedule(cls, schedule: str = "linear", n_timestep: int = 500,
                      linear_start: float = 1e-6, linear_end: float = 1e-2
                      ) -> "SR3Diffusion":
        betas = make_beta_schedule(schedule, n_timestep, linear_start, linear_end)
        return cls(buffers=ddpm_buffers(betas))


@torch.no_grad()
def sr3_sample(diff: SR3Diffusion, model, cond: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """Reverse diffusion from t = T-1 to 0 conditioned on `cond`.

    cond: [N, H, W, 3] in [-1, 1]; noise: [T+1, N, H, W, 3] unit normals;
    model(x [N, 6, H, W], noise_level [N, 1]) -> eps [N, 3, H, W].
    Returns x_0 [N, H, W, 3] fp32."""
    buf = diff.buffers
    T = buf.num_timesteps
    if noise.shape[0] != T + 1 or noise.shape[1:] != cond.shape:
        raise ValueError(f"noise {tuple(noise.shape)} is not [T+1, "
                         f"*cond.shape] = [{T + 1}, {tuple(cond.shape)}]")
    c = cond.permute(0, 3, 1, 2).float()
    noise = noise.permute(0, 1, 4, 2, 3).to(c.device, torch.float32)
    # schedule scalars as host floats: no device reads inside the loop
    tab = {k: getattr(buf, k).tolist() for k in (
        "sqrt_alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
        "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1",
        "posterior_mean_coef2")}
    std = torch.exp(0.5 * buf.posterior_log_variance_clipped).tolist()  # fp32
    x = noise[0]
    n = x.shape[0]
    for i, t in enumerate(range(T - 1, -1, -1)):
        level = torch.full((n, 1), tab["sqrt_alphas_cumprod_prev"][t + 1],
                           dtype=torch.float32, device=c.device)
        eps = model(torch.cat([c, x], dim=1), level)
        x_recon = (tab["sqrt_recip_alphas_cumprod"][t] * x
                   - tab["sqrt_recipm1_alphas_cumprod"][t] * eps).clamp(-1.0, 1.0)
        mean = (tab["posterior_mean_coef1"][t] * x_recon
                + tab["posterior_mean_coef2"][t] * x)
        x = mean + noise[1 + i] * std[t] if t > 0 else mean
    return x.permute(0, 2, 3, 1)
