"""SDXL UNet (XL-base shape), NCHW, split into stages for the first-block
cache (rsvldm_tpu/models/sdxl/unet.py).

Parameter names are sgm openaimodel's (`time_embed.{0,2}`, `label_emb.0.{0,2}`,
`input_blocks.{i}.{0,1}`, `middle_block.{0,1,2}`, `output_blocks.{i}.{0,1,2}`,
`out.{0,2}`; ResBlock `in_layers.{0,2}` / `emb_layers.1` / `out_layers.{0,3}`
/ `skip_connection`; SpatialTransformer `norm`, `proj_in`,
`transformer_blocks.{d}.{attn1,attn2,ff.net.0.proj,ff.net.2,norm1..3}`,
`proj_out`), the names rsvldm_tpu/utils/convert.py reads. Self-attention
goes through ops/attention.py: at the 128^2 latent it sees 4096 and 1024
tokens and runs on the K1 kernel on CUDA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.attention import attention
from ...ops.norm import GroupNorm32, LayerNorm32


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2)
    channel_mult: Sequence[int] = (1, 2, 4)
    num_head_channels: int = 64
    transformer_depth: Sequence[int] = (1, 2, 10)
    context_dim: int = 2048
    adm_in_channels: int = 2816

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


XL_BASE_CONFIG = SDXLUNetConfig()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding in [cos | sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _build_specs(cfg: SDXLUNetConfig):
    """Static block plan (input_specs, output_specs, skip_channels), in the
    order of the torch construction loop."""
    in_specs = []
    skip_ch = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.model_channels * mult
        depth = cfg.transformer_depth[level] if ds in cfg.attention_resolutions else 0
        for _ in range(cfg.num_res_blocks):
            in_specs.append(dict(kind="res", out_ch=out_ch, st_depth=depth))
            ch = out_ch
            skip_ch.append(ch)
        if level != len(cfg.channel_mult) - 1:
            in_specs.append(dict(kind="down", out_ch=ch, st_depth=0))
            skip_ch.append(ch)
            ds *= 2
    out_specs = []
    for level in reversed(range(len(cfg.channel_mult))):
        out_ch = cfg.model_channels * cfg.channel_mult[level]
        depth = cfg.transformer_depth[level] if ds in cfg.attention_resolutions else 0
        for i in range(cfg.num_res_blocks + 1):
            has_up = (level != 0) and (i == cfg.num_res_blocks)
            out_specs.append(dict(out_ch=out_ch, st_depth=depth, has_up=has_up))
            if has_up:
                ds //= 2
    return in_specs, out_specs, skip_ch


def _to_tokens(x):
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).transpose(1, 2)


def _from_tokens(y, h, w):
    b, _, c = y.shape
    return y.transpose(1, 2).reshape(b, c, h, w)


class ResBlock(nn.Module):
    """GN/silu/conv -> +emb -> GN/silu/conv + skip; GroupNorm eps 1e-5."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(in_ch, eps=1e-5), nn.SiLU(),
                                        nn.Conv2d(in_ch, out_ch, 3, padding=1)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(emb_dim, out_ch)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_ch, eps=1e-5), nn.SiLU(), nn.Identity(),
            nn.Conv2d(out_ch, out_ch, 3, padding=1)])
        self.skip_connection = (nn.Conv2d(in_ch, out_ch, 1)
                                if in_ch != out_ch else None)

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, :, None, None].to(h.dtype)
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class CrossAttention(nn.Module):
    """q/k/v/out projections around ops.attention ([B, S, H, D] layout)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int = 64,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, sq, _ = q.shape
        sk = k.shape[1]
        out = attention(q.reshape(b, sq, self.heads, self.dim_head),
                        k.reshape(b, sk, self.heads, self.dim_head),
                        v.reshape(b, sk, self.heads, self.dim_head))
        return self.to_out[0](out.reshape(b, sq, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")  # flax nn.gelu default


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.norm3 = LayerNorm32(dim, eps=1e-5)

    def forward(self, x, context):
        dt = x.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        return x + self.ff(self.norm3(x).to(dt))


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> linear proj_in -> depth blocks -> proj_out + residual."""

    def __init__(self, ch: int, depth: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, heads, dim_head, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        h, w = x.shape[2:]
        y = self.proj_in(_to_tokens(self.norm(x)))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return _from_tokens(self.proj_out(y), h, w) + x


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _input_cells(cfg: SDXLUNetConfig, in_specs) -> nn.ModuleList:
    """input_blocks: [0] = conv_in, then one ModuleList per spec."""
    heads = lambda ch: ch // cfg.num_head_channels
    cells = [nn.ModuleList([nn.Conv2d(cfg.in_channels, cfg.model_channels, 3,
                                      padding=1)])]
    ch = cfg.model_channels
    for s in in_specs:
        if s["kind"] == "down":
            cells.append(nn.ModuleList([Downsample(ch)]))
            continue
        cell = [ResBlock(ch, s["out_ch"], cfg.time_embed_dim)]
        ch = s["out_ch"]
        if s["st_depth"] > 0:
            cell.append(SpatialTransformer(ch, s["st_depth"], heads(ch),
                                           cfg.num_head_channels, cfg.context_dim))
        cells.append(nn.ModuleList(cell))
    return nn.ModuleList(cells)


def _run_cell(cell, h, emb, context):
    """One input/output cell's main part: ResBlock (+ SpatialTransformer)."""
    first = cell[0]
    if isinstance(first, Downsample):
        return first(h)
    h = first(h, emb)
    if len(cell) > 1 and isinstance(cell[1], SpatialTransformer):
        h = cell[1](h, context)
    return h


def has_up(cell) -> bool:
    """Whether an output cell ends in an Upsample (applied after the
    control injection that precedes it)."""
    return isinstance(cell[-1], Upsample)


class _EncoderHalf(nn.Module):
    """time/label embedding, input blocks and middle block: shared by the
    UNet and GLVControl."""

    def __init__(self, cfg: SDXLUNetConfig):
        super().__init__()
        self.cfg = cfg
        ted = cfg.time_embed_dim
        self.in_specs, self.out_specs, self.skip_ch = _build_specs(cfg)
        self.time_embed = nn.ModuleList([nn.Linear(cfg.model_channels, ted),
                                         nn.SiLU(), nn.Linear(ted, ted)])
        self.label_emb = nn.ModuleList([nn.ModuleList([
            nn.Linear(cfg.adm_in_channels, ted), nn.SiLU(), nn.Linear(ted, ted)])])
        self.input_blocks = _input_cells(cfg, self.in_specs)
        mid = cfg.model_channels * cfg.channel_mult[-1]
        self.middle_block = nn.ModuleList([
            ResBlock(mid, mid, ted),
            SpatialTransformer(mid, cfg.transformer_depth[-1],
                               mid // cfg.num_head_channels,
                               cfg.num_head_channels, cfg.context_dim),
            ResBlock(mid, mid, ted)])

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def time_cond(self, timesteps, y):
        """emb = time_embed(t_emb) + label_emb(y)."""
        t = timestep_embedding(timesteps, self.cfg.model_channels).to(self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t)))
        if y is not None:
            le = self.label_emb[0]
            emb = emb + le[2](F.silu(le[0](y.to(self.dtype))))
        return emb

    def middle(self, h, emb, context):
        h = self.middle_block[0](h, emb)
        h = self.middle_block[1](h, context)
        return self.middle_block[2](h, emb)


class UNetModel(_EncoderHalf):
    """SDXL UNet as stages: time_cond / encode / middle / output blocks /
    final. ControlledUNet walks the output blocks with the injections."""

    def __init__(self, cfg: SDXLUNetConfig = XL_BASE_CONFIG):
        super().__init__(cfg)
        heads = lambda ch: ch // cfg.num_head_channels
        ch = cfg.model_channels * cfg.channel_mult[-1]
        skips = list(self.skip_ch)
        cells = []
        for s in self.out_specs:
            cell = [ResBlock(ch + skips.pop(), s["out_ch"], cfg.time_embed_dim)]
            ch = s["out_ch"]
            if s["st_depth"] > 0:
                cell.append(SpatialTransformer(ch, s["st_depth"], heads(ch),
                                               cfg.num_head_channels,
                                               cfg.context_dim))
            if s["has_up"]:
                cell.append(Upsample(ch))
            cells.append(nn.ModuleList(cell))
        self.output_blocks = nn.ModuleList(cells)
        self.out = nn.ModuleList([GroupNorm32(ch, eps=1e-5), nn.SiLU(),
                                  nn.Conv2d(ch, cfg.out_channels, 3, padding=1)])

    def encode(self, x, emb, context):
        """conv_in + input blocks -> (h, skip list)."""
        h = self.input_blocks[0][0](x.to(self.dtype))
        hs = [h]
        for cell in self.input_blocks[1:]:
            h = _run_cell(cell, h, emb, context)
            hs.append(h)
        return h, hs

    def final(self, h):
        return self.out[2](F.silu(self.out[0](h))).float()
