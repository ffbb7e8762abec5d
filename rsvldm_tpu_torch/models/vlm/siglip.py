"""SigLIP vision tower (rsvldm_tpu/models/vlm/siglip.py), the alternate
LLaVA tower family.

Parameter names are HF SiglipVisionModel's (`vision_model.embeddings.
{patch_embedding (with bias), position_embedding}`,
`vision_model.encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj,
layer_norm2, mlp.fc1, mlp.fc2}`), the names convert_hf_siglip_vision reads;
the checkpoint's post_layernorm and head are not used. No CLS token, a
learned position table, pre-LN blocks (eps 1e-6) with tanh GELU; the
patch features of block `select_layer`'s output, the blocks after it not
run. Pixels come in [N, H, W, 3].
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops.norm import LayerNorm32
from .vision import _MLP, _SelfAttention


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    width: int = 1152
    layers: int = 27
    heads: int = 16
    mlp_dim: int = 4304
    select_layer: int = -2

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


SIGLIP_SO400M_384_CONFIG = SigLIPVisionConfig()


class SigLIPBlock(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.width, eps=1e-6)
        self.self_attn = _SelfAttention(cfg.width, cfg.heads)
        self.layer_norm2 = LayerNorm32(cfg.width, eps=1e-6)
        self.mlp = _MLP(cfg.width, cfg.mlp_dim, "gelu_tanh")

    def forward(self, x):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt))
        return x + self.mlp(self.layer_norm2(x).to(dt))


class _Embeddings(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.width)


class _Encoder(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(SigLIPBlock(cfg) for _ in range(cfg.layers))


class _VisionModel(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)


class SigLIPVisionTower(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig = SIGLIP_SO400M_384_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] -> [N, (S/patch)^2, width] (no CLS)."""
        cfg, emb = self.cfg, self.vision_model.embeddings
        dt = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(dt))
        x = x.flatten(2).transpose(1, 2) + emb.position_embedding.weight[None].to(dt)
        n_run = (cfg.layers + cfg.select_layer + 1 if cfg.select_layer < 0
                 else cfg.select_layer)
        for block in self.vision_model.encoder.layers[:n_run]:
            x = block(x)
        return x
