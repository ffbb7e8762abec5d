"""T5 text encoder (rsvldm_tpu/models/text/t5.py), the backbone of sgm's
FrozenT5Embedder (T5-v1.1-XXL).

Parameter names are HF T5EncoderModel's (`shared`, `encoder.block.{i}.
layer.0.SelfAttention.{q,k,v,o}` and block 0's `relative_attention_bias`,
`layer.{0,1}.layer_norm`, `layer.1.DenseReluDense.{wi_0, wi_1 | wi, wo}`,
`encoder.final_layer_norm`), the names convert_t5_encoder reads.
T5LayerNorm (RMS without mean subtraction, scale only), unscaled attention
logits plus a relative-position bias shared by every layer (bidirectional
buckets), bias-free projections, and the v1.1 gated tanh-GELU FFN (ReLU
without `gated_ff`). Attention is plain PyTorch: the bias is not K1's
mask, and the prompts are 77 tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096          # t5-v1_1-xxl
    d_kv: int = 64
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6
    gated_ff: bool = True


T5_V1_1_XXL_CONFIG = T5Config()


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        n = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps))
        return (n.to(x.dtype) * self.weight).to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets (HF T5Attention._relative_position_bucket, JAX
    `relative_position_bucket`), the log taken in fp32 as JAX takes it."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.tensor(np.float32(np.log(max_distance / max_exact)))
    val = (torch.log(n.float() / max_exact + 1e-6) / denom
           * (num_buckets - max_exact)).to(torch.int32) + max_exact
    val = val.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.heads)


class _AttnLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.ln_eps)


class _DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated_ff
        if cfg.gated_ff:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        if self.gated:
            f = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            f = F.relu(self.wi(h))
        return self.wo(f)


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.ln_eps)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList([_AttnLayer(cfg, has_bias), _FFLayer(cfg)])

    def forward(self, x, pos_bias):
        cfg = self.cfg
        attn, ff = self.layer
        sa = attn.SelfAttention
        h = attn.layer_norm(x)
        b, s, _ = h.shape
        split = lambda t: t.reshape(b, s, cfg.heads, cfg.d_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", split(sa.q(h)).float(),
                              split(sa.k(h)).float()) + pos_bias
        v = split(sa.v(h))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        x = x + sa.o(o.reshape(b, s, -1))
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg.layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.ln_eps)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config = T5_V1_1_XXL_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> last_hidden_state [B, S, d_model]."""
        cfg = self.cfg
        blocks = self.encoder.block
        x = self.shared(tokens).to(blocks[0].layer[0].layer_norm.weight.dtype)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.rel_buckets, cfg.rel_max_distance)
        table = blocks[0].layer[0].SelfAttention.relative_attention_bias.weight
        pos_bias = table.float()[buckets.long()].permute(2, 0, 1)[None]
        for block in blocks:
            x = block(x, pos_bias)
        return self.encoder.final_layer_norm(x)
