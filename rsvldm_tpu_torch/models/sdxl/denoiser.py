"""Discrete EDM-preconditioned denoiser over the controlled SDXL UNet
(rsvldm_tpu/models/sdxl/denoiser.py).

D(x, sigma) = c_skip * x + c_out * F(c_in * x, idx(sigma), cond), sigma
quantized to the nearest entry of the 1000-step LegacyDDPM table. `first`
runs GLVControl and the UNet input blocks; `rest` the middle and the injected
decoder (skipped on a first-block cache hit). Latents NCHW. sigma [N] and
the control scale may be device tensors, so that the RestoreEDM loop's
captured steps read them at replay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ...diffusion import scalings
from ...diffusion.schedules import legacy_ddpm_sigmas, sigma_to_idx
from .control import ControlledUNet, GLVControl


@dataclasses.dataclass
class PartialState:
    """What `rest` needs from `first`."""
    h: torch.Tensor          # last input-block feature (the cache key)
    hs: list                 # skip features
    emb: torch.Tensor
    control: list            # GLVControl features
    x: torch.Tensor          # the unscaled noisy latent
    c_skip: torch.Tensor
    c_out: torch.Tensor


@dataclasses.dataclass
class ControlDenoiser:
    unet: ControlledUNet
    control_net: GLVControl
    num_idx: int = 1000

    def __post_init__(self):
        dev = self.unet.time_embed[0].weight.device
        # ascending full sigma table (no appended zero)
        self.sigma_table = legacy_ddpm_sigmas(
            self.num_idx, do_append_zero=False, flip=True).to(dev)

    def _precondition(self, sigma: torch.Tensor):
        idx = sigma_to_idx(sigma, self.sigma_table)
        s4 = self.sigma_table[idx].reshape(-1, 1, 1, 1)
        c_skip, c_out, c_in, _ = scalings.eps_scaling(s4)
        return idx, c_skip, c_out, c_in

    def first_block_shape(self, n: int, h: int, w: int):
        """Shape of the last input-block feature for n latents of h x w."""
        cfg = self.unet.cfg
        ds = 2 ** (len(cfg.channel_mult) - 1)
        return (n, cfg.model_channels * cfg.channel_mult[-1], h // ds, w // ds)

    @torch.no_grad()
    def first(self, x: torch.Tensor, sigma: torch.Tensor,
              cond: Dict[str, torch.Tensor]) -> PartialState:
        idx, c_skip, c_out, c_in = self._precondition(sigma)
        x_in = x * c_in
        control = self.control_net(cond["control"], x_in, idx,
                                   cond["crossattn"], cond["vector"])
        h, hs, emb = self.unet.input_stage(x_in, idx, cond["crossattn"],
                                           cond["vector"])
        return PartialState(h=h, hs=hs, emb=emb, control=control, x=x,
                            c_skip=c_skip, c_out=c_out)

    @torch.no_grad()
    def rest(self, p: PartialState, cond: Dict[str, torch.Tensor],
             control_scale) -> torch.Tensor:
        f = self.unet.rest_stage(p.h, p.hs, p.emb, cond["crossattn"],
                                 p.control, control_scale)
        return f * p.c_out + p.x * p.c_skip

    def __call__(self, x, sigma, cond, control_scale=1.0):
        return self.rest(self.first(x, sigma, cond), cond, control_scale)
