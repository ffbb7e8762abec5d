"""Vision-token resamplers (rsvldm_tpu/models/vlm/resampler.py): identity,
`spatial_pool`, `masked_drop`, the BLIP-2 Q-Former and the Flamingo
perceiver, and `build_resampler`'s dispatch.

`masked_drop` draws JAX's uniforms from a key (or takes them as an
argument). The two modules carry the
reference's parameter names, the ones convert_qformer / convert_perceiver
read: `query_tokens` [1, L, H], `ln_vision`,
`Qformer.bert.embeddings.LayerNorm`, `Qformer.bert.encoder.layer.{i}.
{attention, crossattention}.{self.{query,key,value}, output.{dense,
LayerNorm}}`, `.intermediate_query.dense`, `.output_query.{dense,
LayerNorm}`; `perceiver.latents`, `perceiver.layers.{i}.0.{norm_media,
norm_latents, to_q, to_kv, to_out}`, `perceiver.layers.{i}.1.{0, 1, 3}`,
`perceiver.norm`. Their attention is plain PyTorch, as JAX's einsums: the
sequences are a few hundred latents and tokens.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
import torch.nn.functional as F

from ...utils import prng


def identity_resampler(features: torch.Tensor, **_) -> torch.Tensor:
    return features


def spatial_pool(features: torch.Tensor, stride: int = 2,
                 mode: str = "average") -> torch.Tensor:
    """[N, s*s, C] -> [N, (s / stride)^2, C], average or max pooled."""
    n, t, c = features.shape
    s = int(math.sqrt(t))
    x = features.reshape(n, s, s, c).permute(0, 3, 1, 2)
    if mode == "average":
        x = F.avg_pool2d(x, stride, stride)
    elif mode == "max":
        x = F.max_pool2d(x, stride, stride)
    else:
        raise ValueError(mode)
    return x.permute(0, 2, 3, 1).reshape(n, -1, c)


def masked_drop(features: torch.Tensor, noise: torch.Tensor | None = None,
                ratio: float = 0.5, deterministic: bool = False,
                key: prng.Key | None = None) -> torch.Tensor:
    """Keep the (1 - ratio) share of tokens with the smallest `noise`
    ([N, T] uniform draws, JAX's uniform(key, (N, T)) unless given, key
    default PRNGKey(0); identity when deterministic or ratio <= 0)."""
    if deterministic or ratio <= 0:
        return features
    n, t, c = features.shape
    keep = max(int(t * (1.0 - ratio)), 1)
    if noise is None:
        noise = prng.uniform(prng.key(0) if key is None else key, (n, t),
                             device=features.device)
    idx = torch.argsort(noise.to(features.device), dim=1, stable=True)[:, :keep]
    return torch.gather(features, 1, idx[:, :, None].expand(n, keep, c))


def _mha(q, k, v, heads: int):
    """softmax(q k^T / sqrt(d)) v over [B, S, heads * d], fp32 logits."""
    b, sq, w = q.shape
    d = w // heads
    split = lambda t: t.reshape(b, t.shape[1], heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", split(q).float(),
                          split(k).float()) / (d ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), split(v).float())
    return o.reshape(b, sq, w).to(q.dtype)


# ------------------------------------------------------------- qformer
@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    encoder_width: int = 1024
    num_latents: int = 32
    cross_attention_freq: int = 2
    ln_eps: float = 1e-12


class _BertSelf(nn.Module):
    def __init__(self, width: int, kv_width: int):
        super().__init__()
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(kv_width, width)
        self.value = nn.Linear(kv_width, width)


class _BertOutput(nn.Module):
    def __init__(self, in_width: int, width: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(in_width, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)


class _BertAttention(nn.Module):
    """Post-LN attention: LN(dense(attn(h, kv)) + h)."""

    def __init__(self, cfg: QFormerConfig, kv_width: int):
        super().__init__()
        self.heads = cfg.heads
        self.self = _BertSelf(cfg.hidden_size, kv_width)
        self.output = _BertOutput(cfg.hidden_size, cfg.hidden_size, cfg.ln_eps)

    def forward(self, h, kv):
        s = self.self
        o = _mha(s.query(h), s.key(kv), s.value(kv), self.heads)
        return self.output.LayerNorm(self.output.dense(o) + h)


class _Dense(nn.Module):
    def __init__(self, a: int, b: int):
        super().__init__()
        self.dense = nn.Linear(a, b)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        self.attention = _BertAttention(cfg, cfg.hidden_size)
        if has_cross:
            self.crossattention = _BertAttention(cfg, cfg.encoder_width)
        self.intermediate_query = _Dense(cfg.hidden_size, cfg.intermediate)
        self.output_query = _BertOutput(cfg.intermediate, cfg.hidden_size,
                                        cfg.ln_eps)

    def forward(self, h, x):
        h = self.attention(h, h)
        if hasattr(self, "crossattention"):
            h = self.crossattention(h, x)
        f = F.gelu(self.intermediate_query.dense(h))
        return self.output_query.LayerNorm(self.output_query.dense(f) + h)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_freq == 0)
            for i in range(cfg.layers))


class _Bert(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)


class _QFormerBody(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.bert = _Bert(cfg)


class QFormerResampler(nn.Module):
    """[B, v, encoder_width] -> [B, num_latents, hidden_size]: the query
    tokens self-attend, cross-attend to the LayerNorm'd image features
    every `cross_attention_freq` layers and take the query branch's FFN;
    post-LN throughout, exact GELU (JAX QFormerResampler)."""

    def __init__(self, cfg: QFormerConfig = QFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.num_latents,
                                                     cfg.hidden_size))
        self.ln_vision = nn.LayerNorm(cfg.encoder_width, eps=1e-5)
        self.Qformer = _QFormerBody(cfg)

    def forward(self, image_features: torch.Tensor) -> torch.Tensor:
        x = self.ln_vision(image_features)
        bert = self.Qformer.bert
        h = self.query_tokens.expand(x.shape[0], -1, -1).to(x.dtype)
        h = bert.embeddings.LayerNorm(h)
        for layer in bert.encoder.layer:
            h = layer(h, x)
        return h


# ----------------------------------------------------------- perceiver
@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    dim: int = 1024
    depth: int = 3
    dim_head: int = 64
    heads: int = 8
    num_latents: int = 32
    ff_mult: float = 4


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.cfg = cfg
        self.norm_media = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.norm_latents = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.to_q = nn.Linear(cfg.dim, inner, bias=False)
        self.to_kv = nn.Linear(cfg.dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, cfg.dim, bias=False)

    def forward(self, x, latents):
        cfg = self.cfg
        x, latents = self.norm_media(x), self.norm_latents(latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        b, nq, nk = q.shape[0], q.shape[1], k.shape[1]
        split = lambda t, n: t.reshape(b, n, cfg.heads, cfg.dim_head)
        sim = torch.einsum("bihd,bjhd->bhij",
                           (split(q, nq) * cfg.dim_head ** -0.5).float(),
                           split(k, nk).float())
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhij,bjhd->bihd", attn.float(),
                           split(v, nk).float()).to(q.dtype)
        return self.to_out(out.reshape(b, nq, -1))


class _PerceiverBody(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(cfg.num_latents, cfg.dim))
        inner = int(cfg.dim * cfg.ff_mult)
        ff = lambda: (nn.Sequential(nn.LayerNorm(cfg.dim, eps=1e-5),
                                    nn.Linear(cfg.dim, inner, bias=False),
                                    nn.GELU(),
                                    nn.Linear(inner, cfg.dim, bias=False))
                      if cfg.ff_mult > 0 else nn.Identity())
        self.layers = nn.ModuleList(nn.ModuleList([PerceiverAttention(cfg), ff()])
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-5)


class PerceiverResampler(nn.Module):
    """[B, v, dim] -> [B, num_latents, dim]: learned latents gather the
    image tokens (K/V over tokens and latents), pre-LN, bias-free, a final
    LayerNorm (JAX PerceiverResampler; with ff_mult <= 0 the latents double
    each layer, the reference's quirk, kept)."""

    def __init__(self, cfg: PerceiverConfig = PerceiverConfig()):
        super().__init__()
        self.cfg = cfg
        self.perceiver = _PerceiverBody(cfg)

    def forward(self, image_features: torch.Tensor) -> torch.Tensor:
        p = self.perceiver
        x = image_features
        latents = p.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        for attn, ff in p.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return p.norm(latents)


def build_resampler(resampler_type: str | None, **kwargs):
    """The reference's resampler dispatch (JAX `build_resampler`): a function
    for identity / spatial_pool / masked_drop, a module for perceiver /
    qformer."""
    if resampler_type in (None, "identity"):
        return identity_resampler
    if resampler_type == "spatial_pool":
        return lambda f, **kw: spatial_pool(f, **{**kwargs, **kw})
    if resampler_type == "masked_drop":
        return lambda f, **kw: masked_drop(f, **{**kwargs, **kw})
    if resampler_type == "perceiver":
        return PerceiverResampler(PerceiverConfig(**kwargs))
    if resampler_type == "qformer":
        return QFormerResampler(QFormerConfig(**kwargs))
    raise ValueError(f"Unknown resampler type: {resampler_type}")
