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

from ...device import resolve_device
from ..sdxl.unet import timestep_embedding
from .clip import CLIPTextTransformer


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


class PreparedConditioner:
    """A fixed prompt set's cond / uncond buffers, precomputed and kept in an
    .npz file (keys crossattn_c, vector_c, crossattn_uc, vector_uc, float32;
    the JAX package's PreparedConditioner reads and writes the same files):
    the text towers do not run. `paired` broadcasts row 0 of the buffers to
    the control's batch. The crossattn buffers take `dtype` (the compute
    dtype, bf16 on the card); the vectors stay fp32, as SDXLConditioner
    builds them."""

    def __init__(self, crossattn_c, vector_c, crossattn_uc, vector_uc,
                 device=None, dtype: torch.dtype = torch.float32):
        dev = resolve_device(device)
        t = lambda x, dt: torch.as_tensor(x).to(dev, dt)
        self.crossattn_c = t(crossattn_c, dtype)
        self.vector_c = t(vector_c, torch.float32)
        self.crossattn_uc = t(crossattn_uc, dtype)
        self.vector_uc = t(vector_uc, torch.float32)

    @classmethod
    def load(cls, path: str, device=None,
             dtype: torch.dtype = torch.float32) -> "PreparedConditioner":
        with np.load(path) as z:
            return cls(z["crossattn_c"], z["vector_c"], z["crossattn_uc"],
                       z["vector_uc"], device=device, dtype=dtype)

    @staticmethod
    def save(path: str, cond: Dict, uc: Dict) -> None:
        # fp32 holds every bf16 value exactly
        f32 = lambda t: t.detach().float().cpu().numpy()
        np.savez(path, crossattn_c=f32(cond["crossattn"]), vector_c=f32(cond["vector"]),
                 crossattn_uc=f32(uc["crossattn"]), vector_uc=f32(uc["vector"]))

    def paired(self, control):
        """(cond, uncond), each buffer's row 0 repeated to control.shape[0]
        rows; control passed through as given."""
        n = control.shape[0]
        tile = lambda x: x[:1].repeat(n, *(1,) * (x.dim() - 1))
        c = dict(crossattn=tile(self.crossattn_c), vector=tile(self.vector_c),
                 control=control)
        uc = dict(crossattn=tile(self.crossattn_uc), vector=tile(self.vector_uc),
                  control=control)
        return c, uc
