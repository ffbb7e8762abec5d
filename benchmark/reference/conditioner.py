"""SDXL conditioner: both text towers + micro-conditioning Fourier embeddings
(rsvldm_tpu/models/text/conditioner.py).

crossattn [N, 77, 2048] = [CLIP-L penultimate | bigG penultimate];
vector [N, 2816] = [bigG pooled | fourier(original_size) | fourier(crop) |
fourier(target_size)], 256 per scalar; control = the LQ latent, passed
through. `PreparedConditioner` keeps a fixed prompt set's buffers in an
.npz file, so that the text towers need not run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .sdxl_unet import timestep_embedding
from .clip_text import CLIPTextTransformer


def concat_timestep_embedding(values: torch.Tensor, outdim: int = 256) -> torch.Tensor:
    """Per-scalar sinusoid, concatenated: [N, D] -> [N, D * outdim]."""
    n, d = values.shape
    return timestep_embedding(values.reshape(-1), outdim).reshape(n, d * outdim)


@dataclasses.dataclass
class SDXLConditioner:
    clip_l: CLIPTextTransformer
    big_g: CLIPTextTransformer

    @torch.no_grad()
    def encode_text(self, tokens_l: torch.Tensor, tokens_g: torch.Tensor):
        out_l = self.clip_l(tokens_l)
        out_g = self.big_g(tokens_g)
        crossattn = torch.cat([out_l["penultimate"], out_g["penultimate"]], dim=-1)
        return crossattn, out_g["pooled"]

    def __call__(self, tokens_l, tokens_g, control, original_size=(1024, 1024),
                 crop_coords=(0, 0), target_size=(1024, 1024)) -> Dict[str, torch.Tensor]:
        n = tokens_l.shape[0]
        crossattn, pooled = self.encode_text(tokens_l, tokens_g)
        mk = lambda pair: torch.tensor(pair, dtype=torch.float32,
                                       device=pooled.device)[None].repeat(n, 1)
        vector = torch.cat([
            pooled.float(),
            concat_timestep_embedding(mk(original_size)),
            concat_timestep_embedding(mk(crop_coords)),
            concat_timestep_embedding(mk(target_size)),
        ], dim=-1)
        return dict(crossattn=crossattn, vector=vector, control=control)

    def paired(self, tokens_l_c, tokens_g_c, tokens_l_uc, tokens_g_uc, control, **kw):
        """(cond, uncond) sharing the micro-conditioning and the control."""
        return (self(tokens_l_c, tokens_g_c, control, **kw),
                self(tokens_l_uc, tokens_g_uc, control, **kw))
