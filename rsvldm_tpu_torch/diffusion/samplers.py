"""RestoreEDM sampler with the dynamic first-block cache
(rsvldm_tpu/diffusion/samplers.py: RestoreEDMConfig, restore_edm_sample).

The JAX package runs the 50 steps as one lax.scan and decides cache hits
inside a lax.cond. Here a step is three functions on device tensors the
loop owns (the latent, x_center, the cached denoised latent, the last
first-block feature, the threshold and a step counter): `first` (churn,
GLVControl and the UNet input blocks on the CFG-doubled batch, the
relative-L1 change and the hit flag), then on a miss `rest` (the middle,
the decoder, CFG, then the update) and on a hit `update` alone (the
restore-CFG drift and the Euler step on the cached latent). On the card
each is captured once into a CUDA graph and replayed
(utils/graphs.StepRunner); on the CPU each is called directly. The host
reads the hit flag once a step to pick the next graph. The per-step scalars
are computed on the host in float32, as in the JAX loop, into a [steps, 6]
table (`step_table`) read at the step counter. The initial noise and the
churn noise are arguments. A caller's `graph_cache` keeps the loop
(`EDMLoop`: its tensors and graphs) per config and input shapes across
calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .guidance import apply_cfg, linear_cfg_scale
from ..utils.graphs import StepRunner, use_graphs
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


def to_d(x, sigma, denoised):
    """The EDM ODE direction (x - denoised) / sigma."""
    return (x - denoised) / sigma


def init_noise_scaling(noise, sigma0):
    """noise * sqrt(1 + sigma_0^2), the factor in float32."""
    return noise * float(np.sqrt(f32(1.0) + f32(sigma0) ** 2))


def _rel_l1(cur, prev):
    """mean|prev - cur| / (mean|prev| + 1e-6), fp32."""
    cur, prev = cur.float(), prev.float()
    return (prev - cur).abs().mean() / (prev.abs().mean() + 1e-6)


# columns of the per-step scalar table
SIGMA_HAT, DT, CFG, CONTROL, RESTORE_W, CHURN = range(6)


def step_table(cfg: RestoreEDMConfig) -> np.ndarray:
    """The per-step scalars [steps, 6], float32 as in the JAX loop:
    sigma_hat, next_sigma - sigma_hat, the CFG scale at sigma_hat, the
    control scale at the pre-churn sigma, the restore-CFG weight (0 where
    the drift is off) and the churn factor sqrt(max(sigma_hat^2 -
    sigma^2, 0))."""
    sigmas = legacy_ddpm_sigmas(cfg.num_steps).numpy()
    steps = sigmas.shape[0] - 1
    gamma_val = (min(cfg.s_churn / steps, 2 ** 0.5 - 1)
                 if cfg.s_churn > 0 else 0.0)
    rows = []
    for i in range(steps):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        gamma = gamma_val if cfg.s_tmin <= sigma <= cfg.s_tmax else 0.0
        sigma_hat = f32(sigma * f32(gamma + 1.0))
        w = (f32(sigma / f32(cfg.sigma_max)) ** f32(cfg.restore_cfg)
             if cfg.restore_cfg > 0 and next_sigma > cfg.restore_cfg_s_tmin
             else 0.0)
        rows.append((sigma_hat, f32(next_sigma - sigma_hat),
                     cfg.cfg_at(sigma_hat), cfg.control_scale_at(sigma), w,
                     np.sqrt(max(sigma_hat ** 2 - sigma ** 2, f32(0)))))
    return np.asarray(rows, np.float32).reshape(steps, 6)


class EDMLoop:
    """RestoreEDM's own tensors on the device (the latent, x_center, the
    cached denoised latent, the last first-block feature, the threshold,
    the step counter, the churn noise and the CFG-doubled conditioning)
    and the runners of its three steps, for one config, denoiser and set
    of input shapes. Built from a call's inputs; `load` copies a later
    call's inputs in and resets the rest, so the kept graphs replay on
    them."""

    def __init__(self, denoiser, cond: Dict, uc: Dict, noise: torch.Tensor,
                 x_center_init: torch.Tensor, cfg: RestoreEDMConfig,
                 churn_noise: torch.Tensor | None, graphs: bool):
        nchw = lambda t: t.permute(0, 3, 1, 2).float()
        dev = noise.device
        n = noise.shape[0]
        sigmas = legacy_ddpm_sigmas(cfg.num_steps).numpy()
        self.cfg = cfg
        self.steps = sigmas.shape[0] - 1
        self.x_scale = float(np.sqrt(f32(1.0) + sigmas[0] ** 2))
        self.churn = None
        if cfg.s_churn > 0:
            self.churn = torch.empty(churn_noise.shape, dtype=torch.float32,
                                     device=dev).permute(0, 1, 4, 2, 3)
        tab = torch.from_numpy(step_table(cfg)).to(dev)
        use_cache = cfg.img_threshold > 0
        self.cond2 = {k: torch.cat([uc[k], cond[k]], dim=0) for k in cond}
        self.cond2["control"] = nchw(self.cond2["control"])
        cond2, churn = self.cond2, self.churn

        # the loop's own tensors: replays overwrite a graph's outputs, so
        # what must outlive a step is copied here
        x = self.x = nchw(noise) * self.x_scale
        x_center = self.x_center = nchw(x_center_init).clone()
        prev_h = self.prev_h = torch.zeros(
            denoiser.first_block_shape(2 * n, *x.shape[2:]),
            dtype=denoiser.unet.dtype, device=dev)
        cached = self.cached = torch.zeros_like(x)
        threshold = self.threshold = torch.tensor(
            cfg.img_threshold, dtype=torch.float32, device=dev)
        thresholds = self.thresholds = torch.zeros(
            self.steps, dtype=torch.float32, device=dev)
        i = self.i = torch.zeros((), dtype=torch.long, device=dev)
        row = lambda: tab.index_select(0, i)[0]
        if churn is not None:
            churn.copy_(churn_noise.permute(0, 1, 4, 2, 3))

        def first():
            """Churn, GLVControl and the UNet input blocks, and the cache
            decision: (part, diff, hit)."""
            r = row()
            if churn is not None:
                eps = churn.index_select(0, i)[0] * cfg.s_noise
                x.copy_(x + eps * r[CHURN])
            part = denoiser.first(torch.cat([x, x], dim=0),
                                  r[SIGMA_HAT].expand(2 * n), cond2)
            if not use_cache:
                return part, None, None
            diff = _rel_l1(part.h, prev_h)
            return part, diff, (i > 0) & (diff < threshold)

        def update():
            """Restore-CFG drift, the Euler step, the threshold's record."""
            r = row()
            denoised = cached
            if cfg.restore_cfg > 0:
                denoised = denoised - (denoised - x_center) * r[RESTORE_W]
            d = (x - denoised) / r[SIGMA_HAT]  # a tensor divisor: JAX's to_d
            x.copy_(x + d * r[DT])
            x_center.copy_(x)
            thresholds.index_copy_(0, i.reshape(1), threshold.reshape(1))
            threshold.mul_(cfg.dec_img)
            i.add_(1)

        def rest(part, diff):
            """The middle, the decoder and CFG (a cache miss), then update."""
            r = row()
            cached.copy_(apply_cfg(denoiser.rest(part, cond2, r[CONTROL]),
                                   r[CFG]))
            if use_cache:
                prev_h.copy_(part.h)
                # step 0 keeps the input threshold
                threshold.copy_(torch.where(i > 0, diff, threshold))
            update()

        self.use_cache = use_cache
        self.runners = {k: StepRunner(f, graphs) for k, f in
                        (("first", first), ("rest", rest), ("update", update))}

    def load(self, cond: Dict, uc: Dict, noise: torch.Tensor,
             x_center_init: torch.Tensor, churn_noise: torch.Tensor | None):
        for k in cond:
            src = torch.cat([uc[k], cond[k]], dim=0)
            self.cond2[k].copy_(src.permute(0, 3, 1, 2) if k == "control"
                                else src)
        self.x.copy_(noise.permute(0, 3, 1, 2) * self.x_scale)
        self.x_center.copy_(x_center_init.permute(0, 3, 1, 2))
        self.prev_h.zero_()
        self.cached.zero_()
        self.threshold.fill_(self.cfg.img_threshold)
        self.thresholds.zero_()
        self.i.zero_()
        if self.churn is not None:
            self.churn.copy_(churn_noise.permute(0, 1, 4, 2, 3))

    def run(self, stats: dict | None = None):
        """The steps, one host read of the hit flag each: (x_0 [N, h, w, 4]
        fp32, its own tensor; the hit trace)."""
        runners = self.runners
        captured = {k: r.capture_s for k, r in runners.items()}
        hits = []
        for _ in range(self.steps):
            part, diff, hit = runners["first"]()
            # one host read a step: the cache decision picks the next graph
            was_hit = self.use_cache and bool(hit)
            if was_hit:
                runners["update"]()
            else:
                runners["rest"](part, diff)
            hits.append(was_hit)
            del part, diff, hit
        if stats is not None:
            stats["capture_s"] = {k: r.capture_s - captured[k]
                                  for k, r in runners.items()}
        return self.x.permute(0, 2, 3, 1).clone(), hits


@torch.no_grad()
def restore_edm_sample(denoiser, cond: Dict, uc: Dict, noise: torch.Tensor,
                       x_center_init: torch.Tensor, cfg: RestoreEDMConfig,
                       churn_noise: torch.Tensor | None = None,
                       return_aux: bool = False, graphs: bool | None = None,
                       stats: dict | None = None,
                       graph_cache: dict | None = None):
    """RestoreEDM loop. cond/uc: dicts crossattn [N,77,C], vector [N,adm],
    control [N,h,w,4]; noise [N,h,w,4] and x_center_init [N,h,w,4] (the
    re-encoded Stage-1 latent); churn_noise [steps, N,h,w,4], needed when
    s_churn > 0. graphs: replay the three step functions as CUDA graphs
    (default: on CUDA); stats, when given, receives each one's capture
    seconds in this call. graph_cache, a dict the caller keeps, keeps the
    loop (`EDMLoop`) per config, denoiser and input shapes, so a later call
    of the same shapes replays the kept graphs. Returns the final latent
    [N,h,w,4] fp32 and, with return_aux, dict(cache_hits, num_steps,
    thresholds, hit_trace)."""
    if cfg.s_churn > 0 and churn_noise is None:
        raise ValueError("s_churn > 0 needs churn_noise [steps, N, h, w, 4]")
    on = use_graphs(noise.device, graphs)
    key = (cfg, id(denoiser), on, tuple(noise.shape),
           *((k, tuple(v.shape), v.dtype) for k, v in sorted(cond.items())))
    loop = (graph_cache or {}).get(key)
    if loop is None:
        loop = EDMLoop(denoiser, cond, uc, noise, x_center_init, cfg,
                       churn_noise, on)
        if graph_cache is not None:
            graph_cache[key] = loop
    else:
        loop.load(cond, uc, noise, x_center_init, churn_noise)
    out, hits = loop.run(stats)
    if not return_aux:
        return out
    return out, dict(cache_hits=int(sum(hits)), num_steps=loop.steps,
                     thresholds=loop.thresholds.cpu().numpy(),
                     hit_trace=np.asarray(hits, dtype=bool))
