"""RestoreEDM sampler with the dynamic first-block cache
(rsvldm_tpu/diffusion/samplers.py: RestoreEDMConfig, restore_edm_sample).

The JAX package runs the 50 steps as one lax.scan and decides cache hits
inside a lax.cond. Here the loop is Python and the decision is a Python `if`
on a boolean read from the device: one host sync per step. Every step runs
GLVControl and the UNet input blocks on the CFG-doubled batch; on a hit the
middle, decoder and CFG are skipped and the last denoised latent is reused.
Scalar schedule arithmetic is float32, as in the JAX loop. The initial noise
and the churn noise are arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .guidance import apply_cfg, linear_cfg_scale
from .schedules import legacy_ddpm_sigmas

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class RestoreEDMConfig:
    num_steps: int = 50
    cfg_scale: float = 7.5
    cfg_scale_start: float = 4.0    # scale at sigma_max with linear CFG
    use_linear_cfg: bool = True
    restore_cfg: float = -1.0       # <= 0 disables the drift to x_center
    restore_cfg_s_tmin: float = 0.05
    s_churn: float = 5.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.003
    sigma_max: float = 14.6146
    control_scale: float = 1.0
    use_linear_control_scale: bool = False
    control_scale_start: float = 0.0
    img_threshold: float = 0.3      # first-block cache threshold; <= 0 off
    dec_img: float = 1.0

    def cfg_at(self, sigma):
        if self.use_linear_cfg:
            return f32(linear_cfg_scale(f32(sigma), f32(self.cfg_scale_start),
                                        f32(self.cfg_scale)))
        return self.cfg_scale

    def control_scale_at(self, sigma):
        if not self.use_linear_control_scale:
            return self.control_scale
        return f32((f32(sigma) / f32(self.sigma_max))
                   * f32(self.control_scale_start - self.control_scale)
                   + f32(self.control_scale))


def _rel_l1(cur, prev):
    """mean|prev - cur| / (mean|prev| + 1e-6), fp32."""
    cur, prev = cur.float(), prev.float()
    return (prev - cur).abs().mean() / (prev.abs().mean() + 1e-6)


@torch.no_grad()
def restore_edm_sample(denoiser, cond: Dict, uc: Dict, noise: torch.Tensor,
                       x_center_init: torch.Tensor, cfg: RestoreEDMConfig,
                       churn_noise: torch.Tensor | None = None,
                       return_aux: bool = False):
    """RestoreEDM loop. cond/uc: dicts crossattn [N,77,C], vector [N,adm],
    control [N,h,w,4]; noise [N,h,w,4] and x_center_init [N,h,w,4] (the
    re-encoded Stage-1 latent); churn_noise [steps, N,h,w,4], needed when
    s_churn > 0. Returns the final latent [N,h,w,4] fp32 and, with
    return_aux, dict(cache_hits, num_steps, thresholds, hit_trace)."""
    nchw = lambda t: t.permute(0, 3, 1, 2).float()
    n = noise.shape[0]
    sigmas = legacy_ddpm_sigmas(cfg.num_steps).numpy()
    num_sigmas = sigmas.shape[0]
    x = nchw(noise) * float(np.sqrt(f32(1.0) + sigmas[0] ** 2))
    x_center = nchw(x_center_init)

    cond2 = {k: torch.cat([uc[k], cond[k]], dim=0) for k in cond}
    cond2["control"] = nchw(cond2["control"])
    gamma_val = (min(cfg.s_churn / (num_sigmas - 1), 2 ** 0.5 - 1)
                 if cfg.s_churn > 0 else 0.0)
    if gamma_val > 0 and churn_noise is None:
        raise ValueError("s_churn > 0 needs churn_noise [steps, N, h, w, 4]")
    use_cache = cfg.img_threshold > 0

    prev_h = torch.zeros(denoiser.first_block_shape(2 * n, *x.shape[2:]),
                         dtype=denoiser.unet.dtype, device=x.device)
    cached = torch.zeros_like(x)
    threshold = torch.tensor(cfg.img_threshold, dtype=torch.float32,
                             device=x.device)
    thresholds, hits = [], []
    for i in range(num_sigmas - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        gamma = gamma_val if cfg.s_tmin <= sigma <= cfg.s_tmax else 0.0
        sigma_hat = f32(sigma * f32(gamma + 1.0))
        if gamma_val > 0:
            eps = churn_noise[i].permute(0, 3, 1, 2).to(x) * cfg.s_noise
            x = x + eps * float(np.sqrt(max(sigma_hat ** 2 - sigma ** 2, f32(0))))

        part = denoiser.first(torch.cat([x, x], dim=0),
                              torch.full((2 * n,), float(sigma_hat),
                                         device=x.device), cond2)
        # linear control scale uses the pre-churn sigma
        cs = cfg.control_scale_at(sigma)
        was_hit = False
        if use_cache:
            diff = _rel_l1(part.h, prev_h)
            # one host sync per step: the decision is read back to Python
            was_hit = i > 0 and bool(diff < threshold)
        if was_hit:
            denoised = cached
        else:
            denoised = apply_cfg(denoiser.rest(part, cond2, cs),
                                 float(cfg.cfg_at(sigma_hat)))
            if use_cache:
                prev_h = part.h
                if i > 0:  # step 0 keeps the input threshold
                    threshold = diff
        cached = denoised
        del part

        if cfg.restore_cfg > 0 and next_sigma > cfg.restore_cfg_s_tmin:
            w = float(f32(sigma / f32(cfg.sigma_max)) ** f32(cfg.restore_cfg))
            denoised = denoised - (denoised - x_center) * w
        d = (x - denoised) / float(sigma_hat)
        x = x + d * float(f32(next_sigma - sigma_hat))
        x_center = x
        thresholds.append(threshold)
        threshold = threshold * cfg.dec_img
        hits.append(was_hit)

    out = x.permute(0, 2, 3, 1)
    if not return_aux:
        return out
    return out, dict(cache_hits=int(sum(hits)), num_steps=num_sigmas - 1,
                     thresholds=torch.stack(thresholds).cpu().numpy(),
                     hit_trace=np.asarray(hits, dtype=bool))
