"""SR3 denoising UNet, NCHW (rsvldm_tpu/models/sr3/unet.py).

Parameter names are the reference checkpoint's (I1000000_E800_gen.pth, the
names rsvldm_tpu/utils/convert.py::convert_sr3_unet reads): flat ModuleLists
`downs` / `mid` / `ups`, `Block.block.{0: GroupNorm, 3: Conv2d}`,
`noise_func.noise_func.0`, `noise_level_mlp.{1,3}`. The attention at 28^2 =
784 tokens stays a plain matmul pair, as the JAX einsum does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.norm import GroupNorm32


@dataclasses.dataclass(frozen=True)
class SR3UNetConfig:
    in_channel: int = 6
    out_channel: int = 3
    inner_channel: int = 64
    norm_groups: int = 32
    channel_mults: Sequence[int] = (1, 2, 4, 8, 8)
    attn_res: Sequence[int] = (28,)
    res_blocks: int = 1
    image_size: int = 224


def noise_level_embedding(noise_level: torch.Tensor, dim: int) -> torch.Tensor:
    """WaveGrad encoding of a continuous noise level: [B] or [B,1] -> [B, dim]
    as [sin | cos]."""
    noise_level = noise_level.reshape(-1).float()
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32, device=noise_level.device) / count
    enc = noise_level[:, None] * torch.exp(-math.log(1e4) * step[None, :])
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


class Block(nn.Module):
    """GroupNorm -> swish -> (dropout) -> 3x3 conv; GroupNorm and swish in
    fp32, as flax GroupNorm(dtype=float32)."""

    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.block = nn.ModuleList([
            GroupNorm32(dim, eps=1e-5, num_groups=groups), nn.SiLU(),
            nn.Identity(), nn.Conv2d(dim, dim_out, 3, padding=1)])

    def forward(self, x):
        conv = self.block[3]
        h = F.silu(self.block[0].forward_fp32(x)).to(conv.weight.dtype)
        return conv(h)


class FeatureWiseAffine(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(in_channels, out_channels))

    def forward(self, x, temb):
        return x + self.noise_func(temb)[:, :, None, None].to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, temb_dim: int, groups: int):
        super().__init__()
        self.block1 = Block(dim, dim_out, groups)
        self.noise_func = FeatureWiseAffine(temb_dim, dim_out)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, temb):
        h = self.noise_func(self.block1(x), temb)
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class SelfAttention(nn.Module):
    """Single-head self-attention over the spatial tokens, scale 1/sqrt(C),
    fp32 logits and softmax, residual output conv."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-5, num_groups=groups)
        self.qkv = nn.Conv2d(channels, channels * 3, 1, bias=False)
        self.out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        dt = self.qkv.weight.dtype
        qkv = self.qkv(self.norm.forward_fp32(x).to(dt)).reshape(b, 3 * c, h * w)
        q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
        attn = torch.einsum("bcq,bck->bqk", q.float(), k.float()) / math.sqrt(c)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.bmm(v, attn.transpose(1, 2)).to(x.dtype).reshape(b, c, h, w)
        return self.out(out) + x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim: int, dim_out: int, temb_dim: int, groups: int,
                 with_attn: bool):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, temb_dim, groups)
        self.attn = SelfAttention(dim_out, groups) if with_attn else None

    def forward(self, x, temb):
        x = self.res_block(x, temb)
        return self.attn(x) if self.attn is not None else x


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class SR3UNet(nn.Module):
    """Encoder/mid/decoder UNet with a skip concat at every recorded feature.
    forward(x [N, 6, H, W] = [bicubic LR | x_t], noise_level [N] or [N, 1])
    -> eps [N, 3, H, W] fp32. Attention levels follow cfg.image_size, as in
    the JAX module."""

    def __init__(self, cfg: SR3UNetConfig):
        super().__init__()
        self.cfg = cfg
        inner, groups = cfg.inner_channel, cfg.norm_groups
        self.noise_level_mlp = nn.ModuleList([
            nn.Identity(), nn.Linear(inner, inner * 4), nn.SiLU(),
            nn.Linear(inner * 4, inner)])
        num_mults = len(cfg.channel_mults)
        now_res = cfg.image_size
        downs = [nn.Conv2d(cfg.in_channel, inner, 3, padding=1)]
        feat_ch = [inner]
        ch = inner
        for ind in range(num_mults):
            use_attn = now_res in cfg.attn_res
            ch_out = inner * cfg.channel_mults[ind]
            for _ in range(cfg.res_blocks):
                downs.append(ResnetBlocWithAttn(ch, ch_out, inner, groups, use_attn))
                feat_ch.append(ch_out)
                ch = ch_out
            if ind != num_mults - 1:
                downs.append(Downsample(ch))
                feat_ch.append(ch)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.mid = nn.ModuleList([
            ResnetBlocWithAttn(ch, ch, inner, groups, True),
            ResnetBlocWithAttn(ch, ch, inner, groups, False)])
        ups = []
        for ind in reversed(range(num_mults)):
            use_attn = now_res in cfg.attn_res
            ch_out = inner * cfg.channel_mults[ind]
            for _ in range(cfg.res_blocks + 1):
                ups.append(ResnetBlocWithAttn(ch + feat_ch.pop(), ch_out, inner,
                                              groups, use_attn))
                ch = ch_out
            if ind > 0:
                ups.append(Upsample(ch))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(ch, cfg.out_channel, groups)

    def forward(self, x, noise_level):
        dt = self.final_conv.block[3].weight.dtype
        mlp = self.noise_level_mlp
        t = noise_level_embedding(noise_level, self.cfg.inner_channel).to(dt)
        temb = mlp[3](F.silu(mlp[1](t)))
        h = x.to(dt)
        feats = []
        for layer in self.downs:
            h = layer(h, temb) if isinstance(layer, ResnetBlocWithAttn) else layer(h)
            feats.append(h)
        for layer in self.mid:
            h = layer(h, temb)
        for layer in self.ups:
            if isinstance(layer, ResnetBlocWithAttn):
                h = layer(torch.cat([h, feats.pop()], dim=1), temb)
            else:
                h = layer(h)
        assert not feats
        return self.final_conv(h).float()
