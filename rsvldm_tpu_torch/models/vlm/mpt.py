"""MPT decoder with its own KV cache (rsvldm_tpu/models/vlm/mpt.py, the
llava_mpt.py language binding).

Parameter names are HF MptForCausalLM's (`transformer.wte`,
`transformer.blocks.{i}.{norm_1, attn.Wqkv, attn.out_proj, norm_2,
ffn.up_proj, ffn.down_proj}`, `transformer.norm_f`), the names convert_mpt
reads; the lm_head is tied to wte. Pre-LN blocks (LayerNorm without bias
when `no_bias`), a fused Wqkv (optionally clipped), ALiBi in place of RoPE,
an exact-GELU 4x MLP.

Attention is plain PyTorch (fp32 logits and softmax over the whole cache),
as in JAX: ALiBi's bias is not K1's mask, so no call reaches K1. The bias is
slope * key position; the per-query constant -slope * query position
cancels in the softmax, so absolute positions serve prefill and decode
alike. New tokens' K/V are written into the preallocated [L, B, T, H, hd]
cache in place (`index_copy_` at the positions, so a decode position can be
a device tensor).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    vocab_size: int = 50432
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    ln_eps: float = 1e-5
    no_bias: bool = True           # mpt-7b: bias-free LayerNorm and Linear
    clip_qkv: float | None = None
    alibi_bias_max: int = 8

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


MPT_7B_CONFIG = MPTConfig()


@dataclasses.dataclass
class MPTKVCache:
    k: torch.Tensor  # [L, B, T, H, hd]
    v: torch.Tensor

    @classmethod
    def init(cls, cfg: MPTConfig, batch: int, max_len: int,
             dtype=torch.float32, device=None) -> "MPTKVCache":
        shape = (cfg.layers, batch, max_len, cfg.heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def alibi_slopes(num_heads: int, alibi_bias_max: int = 8,
                 device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (JAX `alibi_slopes`): powers of 2 over the
    next power-of-two head count, interleaved when the head count is not
    one. fp32 [heads]."""
    n2 = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, n2 + 1, dtype=torch.float32,
                        device=device) * (alibi_bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, base)
    if n2 != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes


class _LayerNorm(nn.LayerNorm):
    """fp32 statistics, the input's dtype out; bias-free with no_bias."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), b, self.eps).to(x.dtype)


class _Attn(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.Wqkv = nn.Linear(cfg.dim, 3 * cfg.dim, bias=not cfg.no_bias)
        self.out_proj = nn.Linear(cfg.dim, cfg.dim, bias=not cfg.no_bias)


class _FFN(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.up_proj = nn.Linear(cfg.dim, 4 * cfg.dim, bias=not cfg.no_bias)
        self.down_proj = nn.Linear(4 * cfg.dim, cfg.dim, bias=not cfg.no_bias)

    def forward(self, h):
        return self.down_proj(F.gelu(self.up_proj(h)))


class MPTBlock(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        ln = lambda: _LayerNorm(cfg.dim, eps=cfg.ln_eps, bias=not cfg.no_bias)
        self.norm_1 = ln()
        self.attn = _Attn(cfg)
        self.norm_2 = ln()
        self.ffn = _FFN(cfg)

    def forward(self, x, cache_k, cache_v, positions):
        """x [B, S, D] at `positions` [S] (a long tensor); cache_k/v
        [B, T, H, hd], written in place."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        qkv = self.attn.Wqkv(self.norm_1(x))
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q, k, v = (t.reshape(b, s, cfg.heads, hd) for t in qkv.chunk(3, dim=-1))
        with torch.no_grad():
            cache_k.index_copy_(1, positions, k.to(cache_k.dtype))
            cache_v.index_copy_(1, positions, v.to(cache_v.dtype))
        t = cache_k.shape[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              cache_k.to(q.dtype).float()) / math.sqrt(hd)
        k_pos = torch.arange(t, device=x.device)
        slopes = alibi_slopes(cfg.heads, cfg.alibi_bias_max, x.device)
        logits = logits + slopes[:, None, None] * k_pos.float()
        mask = k_pos[None, :] <= positions[:, None]  # [S, T]
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                         cache_v.float()).to(x.dtype)
        x = x + self.attn.out_proj(o.reshape(b, s, cfg.dim))
        return x + self.ffn(self.norm_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.blocks = nn.ModuleList(MPTBlock(cfg) for _ in range(cfg.layers))
        self.norm_f = _LayerNorm(cfg.dim, eps=cfg.ln_eps, bias=not cfg.no_bias)


class MPTModel(nn.Module):
    def __init__(self, cfg: MPTConfig = MPT_7B_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.transformer = _Transformer(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.norm_f.weight.dtype

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(tokens).to(self.dtype)

    def forward(self, embeds: torch.Tensor, cache: MPTKVCache,
                start_pos: int | torch.Tensor = 0):
        """embeds [B, S, D] at start_pos.. (an int, or a 0-d long tensor for
        a decode step) -> (fp32 logits [B, S, vocab] from the tied wte, the
        cache written in place)."""
        s = embeds.shape[1]
        positions = (torch.as_tensor(start_pos, device=embeds.device)
                     + torch.arange(s, device=embeds.device))
        x = embeds.to(self.dtype)
        for i, block in enumerate(self.transformer.blocks):
            x = block(x, cache.k[i], cache.v[i], positions)
        x = self.transformer.norm_f(x)
        return F.linear(x.float(), self.transformer.wte.weight.float()), cache
