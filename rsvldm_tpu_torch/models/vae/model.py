"""SDXL KL autoencoder, NCHW (rsvldm_tpu/models/vae/model.py).

Parameter names are the sgm checkpoint's (`encoder.down.{i}.block.{j}`,
`encoder.mid.attn_1.{q,k,v,proj_out}`, `decoder.up.{i}.upsample.conv`,
`quant_conv`, `post_quant_conv`), plus the fine-tuned `denoise_encoder` twin
of the SR overlay checkpoint. The mid attention runs plain torch over all
(H/8 * W/8) tokens in one head, as the JAX einsum does: at 1024^2 that is a
16384^2 fp32 score matrix (1 GiB). models/vae/tiled.py runs the encoder
and decoder over halo-padded tiles instead, with GroupNorm statistics
pooled over the tiles.
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
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.13025


SDXL_VAE_CONFIG = VAEConfig()


def _norm(c: int) -> GroupNorm32:
    return GroupNorm32(c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head attention over the spatial tokens, fp32 logits/softmax."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w)
        attn = torch.bmm(q.float().transpose(1, 2), k.float()) / math.sqrt(c)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        del q, k
        # probabilities in v's dtype, fp32 accumulation inside the matmul
        out = torch.bmm(v, attn.transpose(1, 2)).to(x.dtype).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """SD asymmetric pad (right/bottom) + stride-2 valid conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: `block` ModuleList + optional down/upsample."""


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = VAEAttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        ch = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            level = _Level()
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            level.block = nn.ModuleList(blocks)
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(ch)
            self.down.append(level)
        self.mid = _Mid(ch)
        self.norm_out = _norm(ch)
        out_ch = cfg.z_channels * (2 if cfg.double_z else 1)
        self.conv_out = nn.Conv2d(ch, out_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        up = [None] * len(cfg.ch_mult)
        ch = block_in
        for i in reversed(range(len(cfg.ch_mult))):
            level = _Level()
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, cfg.ch * cfg.ch_mult[i]))
                ch = cfg.ch * cfg.ch_mult[i]
            level.block = nn.ModuleList(blocks)
            if i != 0:
                level.upsample = Upsample(ch)
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(ch)
        self.conv_out = nn.Conv2d(ch, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z.to(self.conv_in.weight.dtype)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h))).float()


class DiagonalGaussian:
    """moments [N, 2z, H, W] -> mean / clipped logvar split on channels."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, noise a unit normal of the mean's shape."""
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL divergence from the unit normal, summed over every dim but
        the batch's: fp32 [N]."""
        mean, logvar = self.mean.float(), self.logvar.float()
        return 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar,
                               dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """KL autoencoder with twin encoders sharing `quant_conv`:
    encode (original encoder), encode_with_denoise (fine-tuned twin), decode.
    Images and latents NCHW; the decoded image is fp32."""

    def __init__(self, cfg: VAEConfig = SDXL_VAE_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.denoise_encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        zf = 2 if cfg.double_z else 1
        self.quant_conv = nn.Conv2d(zf * cfg.z_channels, zf * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def _latent(self, h, noise):
        post = DiagonalGaussian(self.quant_conv(h).float())
        z = post.sample(noise) if noise is not None else post.mode()
        return self.cfg.scale_factor * z

    def encode(self, x, noise: torch.Tensor | None = None):
        """Original encoder -> scaled latent; samples the posterior with
        `noise` when given, else its mode."""
        return self._latent(self.encoder(x), noise)

    def encode_with_denoise(self, x, noise: torch.Tensor | None = None):
        return self._latent(self.denoise_encoder(x), noise)

    def decode(self, z):
        z = z / self.cfg.scale_factor
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))
