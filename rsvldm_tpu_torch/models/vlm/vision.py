"""CLIP ViT-L/14-336 vision tower (rsvldm_tpu/models/vlm/vision.py).

Parameter names are HF CLIPVisionModel's (`vision_model.embeddings.*`,
`vision_model.pre_layrnorm`, `vision_model.encoder.layers.{i}.*`), the names
convert_hf_clip_vision reads. 14x14 patch conv, CLS token, learned
positional table, pre-LN, non-causal blocks with quick_gelu. Features are
the HF hidden state `select_layer` (hidden_states[0] is the pre-LN output,
[i + 1] the output of block i) with the CLS token dropped ('patch'); the
blocks after it are not run. Pixels come in [N, H, W, 3], the JAX layout.

Not ported yet (they raise): the 2D-RoPE tower, the multi-layer slice
feature modes and keep_cls.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops.attention import attention
from ...ops.norm import LayerNorm32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    select_layer: int = -2
    # not ported yet: set away from their defaults they raise
    keep_cls: bool = False
    select_feature: str = ""
    pos_embed: str = "learned"

    def __post_init__(self):
        for name, default in (("keep_cls", False), ("select_feature", ""),
                              ("pos_embed", "learned")):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"CLIPVisionConfig.{name} is not ported yet (the other "
                    "towers and feature modes are queued)")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_L_336_CONFIG = CLIPVisionConfig()


def normalize_pixels(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [0, 1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class _SelfAttention(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, h):
        b, s, w = h.shape
        split = lambda t: t.reshape(b, s, self.heads, w // self.heads)
        o = attention(split(self.q_proj(h)), split(self.k_proj(h)),
                      split(self.v_proj(h)))
        return self.out_proj(o.reshape(b, s, w))


class _MLP(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.fc1 = nn.Linear(w, 4 * w)
        self.fc2 = nn.Linear(4 * w, w)

    def forward(self, h):
        h = self.fc1(h)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class ViTBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.width, eps=1e-5)
        self.self_attn = _SelfAttention(cfg.width, cfg.heads)
        self.layer_norm2 = LayerNorm32(cfg.width, eps=1e-5)
        self.mlp = _MLP(cfg.width)

    def forward(self, x):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt))
        return x + self.mlp(self.layer_norm2(x).to(dt))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.width)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.layers))


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm32(cfg.width, eps=1e-5)
        self.encoder = _Encoder(cfg)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] CLIP-normalized -> [N, (S/14)^2, width]."""
        vm = self.vision_model
        emb = vm.embeddings
        dt = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(dt))
        x = x.flatten(2).transpose(1, 2)  # [N, h*w, W], row-major patches
        cls = emb.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(dt)
        x = vm.pre_layrnorm(x).to(dt)  # hidden_states[0]
        want = self.cfg.select_layer % (self.cfg.layers + 1)
        for block in vm.encoder.layers[:want]:
            x = block(x)
        return x[:, 1:]  # 'patch': CLS dropped
