"""GLVControl ControlNet and the ZeroSFT / ZeroCrossAttn injection UNet
(rsvldm_tpu/models/sdxl/control.py).

Parameter names are the SR checkpoint's: GLVControl is the UNet's encoder
half plus `input_hint_block.0`; ControlledUNet is the UNet plus
`project_modules.{i}` (i = the reference ModuleList index, consumed from the
last), with ZeroSFT `param_free_norm`, `mlp_shared.0`, `zero_mul`,
`zero_add`, `zero_conv` and ZeroCrossAttn `norm1`, `norm2`, `attn.*`.
`input_stage` / `rest_stage` split the model for the first-block cache.
The control scale is a number or a 0-d tensor on the device (the
RestoreEDM loop's, so that a captured step reads each step's scale).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .norm import GroupNorm32
from .sdxl_unet import (CrossAttention, SDXLUNetConfig, UNetModel, XL_BASE_CONFIG,
                   _build_specs, _EncoderHalf, _from_tokens, _run_cell,
                   _to_tokens, has_up)


class ZeroSFT(nn.Module):
    """Spatial feature transform of h by the control feature c:
    h_raw = [h_ori | h]; h = [h_ori | h + zero_conv(c)];
    out = GN(h) * (1 + gamma(c)) + beta(c), lerped with h_raw by the
    control scale."""

    def __init__(self, label_nc: int, norm_nc: int, concat_nc: int = 0,
                 nhidden: int = 128):
        super().__init__()
        total = norm_nc + concat_nc
        self.concat_nc = concat_nc
        self.param_free_norm = GroupNorm32(total, eps=1e-5)
        self.mlp_shared = nn.ModuleList([
            nn.Conv2d(label_nc, nhidden, 3, padding=1), nn.SiLU()])
        self.zero_mul = nn.Conv2d(nhidden, total, 3, padding=1)
        self.zero_add = nn.Conv2d(nhidden, total, 3, padding=1)
        self.zero_conv = nn.Conv2d(label_nc, norm_nc, 1)

    def forward(self, c, h, h_ori=None, control_scale=1.0):
        cat = h_ori is not None and self.concat_nc != 0
        h_raw = torch.cat([h_ori, h], dim=1) if cat else h
        h = h + self.zero_conv(c)
        if cat:
            h = torch.cat([h_ori, h], dim=1)
        actv = F.silu(self.mlp_shared[0](c))
        gamma, beta = self.zero_mul(actv), self.zero_add(actv)
        h = self.param_free_norm(h) * (gamma + 1.0) + beta
        return h * control_scale + h_raw * (1.0 - control_scale)


class ZeroCrossAttn(nn.Module):
    """Cross-attention from the features (queries) to the control feature
    (keys/values), added back scaled by the control scale."""

    def __init__(self, context_dim: int, query_dim: int):
        super().__init__()
        self.norm1 = GroupNorm32(query_dim, eps=1e-5)
        self.norm2 = GroupNorm32(context_dim, eps=1e-5)
        self.attn = CrossAttention(query_dim, query_dim // 64, 64, context_dim)

    def forward(self, c, h, h_ori=None, control_scale=1.0):
        assert h_ori is None, "ZeroCrossAttn is only used at 2-arg sites"
        hh, ww = h.shape[2:]
        x = self.attn(_to_tokens(self.norm1(h)), _to_tokens(self.norm2(c)))
        return h + _from_tokens(x, hh, ww) * control_scale


def derive_project_specs(cfg: SDXLUNetConfig):
    """Project-module plan in consumption order: the middle (ZeroSFT, no
    concat), then per output block its skip site (ZeroSFT) and, before each
    upsample, a ZeroCrossAttn. `label_nc` / `context_dim` are the channels of
    the control feature each site reads."""
    _, out_specs, skip_ch = _build_specs(cfg)
    mid_ch = cfg.model_channels * cfg.channel_mult[-1]
    specs = [dict(kind="sft", norm_nc=mid_ch, concat_nc=0, label_nc=mid_ch)]
    skips = list(skip_ch)
    h_ch = mid_ch
    for cell in out_specs:
        s = skips.pop()
        specs.append(dict(kind="sft", norm_nc=s, concat_nc=h_ch, label_nc=s))
        h_ch = cell["out_ch"]
        if cell["has_up"]:
            specs.append(dict(kind="zca", query_dim=h_ch, context_dim=s))
    return specs


class GLVControl(_EncoderHalf):
    """SDXL encoder half + zero-conv hint on the LQ latent.
    forward(lq [N,4,h,w], x [N,4,h,w], timesteps, context, y) -> the
    multiscale features (conv_in, every input block, middle)."""

    def __init__(self, cfg: SDXLUNetConfig = XL_BASE_CONFIG):
        super().__init__(cfg)
        self.input_hint_block = nn.ModuleList([
            nn.Conv2d(cfg.in_channels, cfg.model_channels, 3, padding=1)])

    def forward(self, lq_latent, noisy_latent, timesteps, context, y):
        emb = self.time_cond(timesteps, y)
        hint = self.input_hint_block[0](lq_latent.to(self.dtype))
        h = self.input_blocks[0][0](noisy_latent.to(self.dtype)) + hint
        hs = [h]
        for cell in self.input_blocks[1:]:
            h = _run_cell(cell, h, emb, context)
            hs.append(h)
        hs.append(self.middle(h, emb, context))
        return hs


class ControlledUNet(UNetModel):
    """SDXL UNet with control injections (LightGLVUNet):
    input_stage(x, t, context, y) -> (h, hs, emb);
    rest_stage(h, hs, emb, context, control, control_scale) -> eps-pred."""

    def __init__(self, cfg: SDXLUNetConfig = XL_BASE_CONFIG):
        super().__init__(cfg)
        specs = derive_project_specs(cfg)
        mods = [ZeroSFT(s["label_nc"], s["norm_nc"], s["concat_nc"])
                if s["kind"] == "sft" else
                ZeroCrossAttn(s["context_dim"], s["query_dim"])
                for s in specs]
        # stored in reference order: consumption index c is module n-1-c
        self.project_modules = nn.ModuleList(reversed(mods))

    def input_stage(self, x, timesteps, context, y):
        emb = self.time_cond(timesteps, y)
        h, hs = self.encode(x, emb, context)
        return h, hs, emb

    def rest_stage(self, h, hs, emb, context, control, control_scale=1.0):
        h = self.middle(h, emb, context)
        projects = list(reversed(self.project_modules))  # consumption order
        ci = len(control) - 1
        h = projects.pop(0)(control[ci], h, None, control_scale)
        ci -= 1
        hs = list(hs)
        for cell in self.output_blocks:
            skip = hs.pop()
            h = projects.pop(0)(control[ci], skip, h, control_scale)
            h = _run_cell(cell, h, emb, context)
            if has_up(cell):
                h = projects.pop(0)(control[ci], h, None, control_scale)
                h = cell[-1](h)
            ci -= 1
        assert not projects
        return self.final(h)
