"""EVA-CLIP vision towers, EVA01 and EVA02 (rsvldm_tpu/models/vlm/eva_vit.py).

Parameter names are the vendored EVA tree's (`patch_embed.proj`,
`cls_token` [1, 1, C], `pos_embed` [1, T + 1, C], `blocks.{i}.{norm1,
norm2, attn.{q_proj, k_proj, v_proj | qkv}, attn.q_bias, attn.v_bias,
attn.inner_attn_ln, attn.proj, mlp.{w1, w2, ffn_ln, w3 | fc1, fc2,
ffn_ln}, gamma_1, gamma_2}`), the names convert_eva_vision reads, so a
checkpoint loads as it is. As in the reference's feature path, the last
block is not built (its weights in a checkpoint are skipped) and no final
norm runs; the CLS token is dropped unless `keep_cls`.

The knobs (JAX EvaVitConfig): `subln` (separate q/k/v, k without bias, a
LayerNorm after attention and inside the FFN), `naiveswiglu` (w1, w2 ->
silu gate -> w3), `rope` (2D rotary angles on the patch grid in the
interleaved-pair convention, the CLS token not rotated, positions rescaled
from the pretrain grid with `intp_freq`), `postnorm`, `ls_init_value`
(layer-scale gammas). Pixels come in [N, H, W, 3].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norm import LayerNorm32


@dataclasses.dataclass(frozen=True)
class EvaVitConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    head_width: int = 64          # heads = width // head_width
    mlp_ratio: float = 2.6667
    qkv_bias: bool = True
    rope: bool = True
    pt_hw_seq_len: int = 16       # pretrain grid side (224 / 14)
    intp_freq: bool = True        # rescale rope positions to this grid
    naiveswiglu: bool = True
    subln: bool = True
    postnorm: bool = False
    ls_init_value: float | None = None

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


# the reference's shipped model_configs (JAX eva_vit.py:96-111)
EVA02_CLIP_L_336_CONFIG = EvaVitConfig()
EVA02_CLIP_L_224_CONFIG = dataclasses.replace(EVA02_CLIP_L_336_CONFIG,
                                              image_size=224)
EVA02_CLIP_B_16_CONFIG = EvaVitConfig(
    image_size=224, patch_size=16, width=768, layers=12, mlp_ratio=2.6667,
    pt_hw_seq_len=16, intp_freq=True)
EVA01_CLIP_G_14_CONFIG = EvaVitConfig(
    image_size=224, patch_size=14, width=1408, layers=40, head_width=88,
    mlp_ratio=4.3637, rope=False, naiveswiglu=False, subln=False,
    intp_freq=False)
EVA_GEOMETRIES = {
    "eva02-clip-l-14-336": EVA02_CLIP_L_336_CONFIG,
    "eva02-clip-l-14": EVA02_CLIP_L_224_CONFIG,
    "eva02-clip-b-16": EVA02_CLIP_B_16_CONFIG,
    "eva01-clip-g-14": EVA01_CLIP_G_14_CONFIG,
}


def _rope_tables(cfg: EvaVitConfig):
    """VisionRotaryEmbeddingFast's tables (JAX `_rope_tables`, the same
    float64 numpy then float32): (cos, sin) [T, head_width]."""
    dim = cfg.head_width // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    ft = cfg.num_patches_per_side
    if cfg.intp_freq:
        t = np.arange(ft) / ft * cfg.pt_hw_seq_len
    else:
        t = np.arange(ft, dtype=np.float64)
    fr = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)
    row = np.broadcast_to(fr[:, None, :], (ft, ft, fr.shape[-1]))
    col = np.broadcast_to(fr[None, :, :], (ft, ft, fr.shape[-1]))
    full = np.concatenate([row, col], axis=-1).reshape(ft * ft, -1)
    return (np.cos(full).astype(np.float32), np.sin(full).astype(np.float32))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    xr = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(x.shape)


def _rope_apply(x, cos, sin):
    """[B, T, H, D] patch tokens, rotated in fp32, cast back."""
    xf = x.float()
    return (xf * cos[None, :, None] + _rotate_half_interleaved(xf)
            * sin[None, :, None]).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: EvaVitConfig):
        super().__init__()
        w = cfg.width
        self.cfg = cfg
        if cfg.subln:
            self.q_proj = nn.Linear(w, w, bias=False)
            self.k_proj = nn.Linear(w, w, bias=False)
            self.v_proj = nn.Linear(w, w, bias=False)
            self.inner_attn_ln = LayerNorm32(w, eps=1e-6)
        else:
            self.qkv = nn.Linear(w, 3 * w, bias=False)
        if cfg.qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(w))
            self.v_bias = nn.Parameter(torch.zeros(w))
        self.proj = nn.Linear(w, w)

    def forward(self, h, rope=None):
        cfg = self.cfg
        b, s, w = h.shape
        if cfg.subln:
            q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        else:
            q, k, v = self.qkv(h).chunk(3, dim=-1)
        if cfg.qkv_bias:
            q, v = q + self.q_bias.to(q.dtype), v + self.v_bias.to(v.dtype)
        split = lambda t: t.reshape(b, s, cfg.heads, cfg.head_width)
        q, k, v = split(q), split(k), split(v)
        if rope is not None:
            q = torch.cat([q[:, :1], _rope_apply(q[:, 1:], *rope)], dim=1)
            k = torch.cat([k[:, :1], _rope_apply(k[:, 1:], *rope)], dim=1)
        o = attention(q, k, v).reshape(b, s, w)
        if cfg.subln:
            o = self.inner_attn_ln(o).to(h.dtype)
        return self.proj(o)


class _MLP(nn.Module):
    def __init__(self, cfg: EvaVitConfig):
        super().__init__()
        w, hid = cfg.width, cfg.mlp_hidden
        self.swiglu = cfg.naiveswiglu
        if cfg.naiveswiglu:
            self.w1, self.w2, self.w3 = (nn.Linear(w, hid), nn.Linear(w, hid),
                                         nn.Linear(hid, w))
        else:
            self.fc1, self.fc2 = nn.Linear(w, hid), nn.Linear(hid, w)
        self.ffn_ln = LayerNorm32(hid, eps=1e-6) if cfg.subln else None

    def forward(self, h):
        hid = (F.silu(self.w1(h)) * self.w2(h) if self.swiglu
               else F.gelu(self.fc1(h)))
        if self.ffn_ln is not None:
            hid = self.ffn_ln(hid).to(h.dtype)
        return self.w3(hid) if self.swiglu else self.fc2(hid)


class EvaBlock(nn.Module):
    def __init__(self, cfg: EvaVitConfig):
        super().__init__()
        self.postnorm = cfg.postnorm
        self.norm1 = LayerNorm32(cfg.width, eps=1e-6)
        self.attn = _Attention(cfg)
        self.norm2 = LayerNorm32(cfg.width, eps=1e-6)
        self.mlp = _MLP(cfg)
        if cfg.ls_init_value is not None:
            self.gamma_1 = nn.Parameter(torch.full((cfg.width,), cfg.ls_init_value))
            self.gamma_2 = nn.Parameter(torch.full((cfg.width,), cfg.ls_init_value))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, rope=None):
        dt = x.dtype
        scaled = lambda v, g: v if g is None else v * g.to(v.dtype)
        if self.postnorm:
            x = x + scaled(self.norm1(self.attn(x, rope)).to(dt), self.gamma_1)
            return x + scaled(self.norm2(self.mlp(x)).to(dt), self.gamma_2)
        x = x + scaled(self.attn(self.norm1(x).to(dt), rope), self.gamma_1)
        return x + scaled(self.mlp(self.norm2(x).to(dt)), self.gamma_2)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: EvaVitConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size)


class EvaVisionTower(nn.Module):
    """The feature tower: patch tokens (CLS at 0 with keep_cls) from the
    penultimate block."""

    def __init__(self, cfg: EvaVitConfig = EVA02_CLIP_L_336_CONFIG,
                 keep_cls: bool = False):
        super().__init__()
        self.cfg, self.keep_cls = cfg, keep_cls
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, cfg.width))
        self.blocks = nn.ModuleList(EvaBlock(cfg) for _ in range(cfg.layers - 1))
        # the fp32 RoPE tables, made once per device on first use: not
        # buffers, since the towers are built on the meta device and cast to
        # the compute dtype, which would leave them unset and in bf16
        self._rope = {}

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] normalized -> [N, T, width]."""
        dt = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(pixels.permute(0, 3, 1, 2).to(dt))
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(dt).expand(x.shape[0], 1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        rope = None
        if self.cfg.rope:
            rope = self._rope.get(x.device)
            if rope is None:
                rope = self._rope[x.device] = tuple(
                    torch.from_numpy(t).to(x.device) for t in _rope_tables(self.cfg))
        for block in self.blocks:
            x = block(x, rope)
        return x if self.keep_cls else x[:, 1:]
