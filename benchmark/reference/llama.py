"""The captioner's decoder in plain torch, fp32, over a whole sequence at
once: RMSNorm with fp32 statistics, rotate-half RoPE, GQA, SwiGLU, the
q/k/v biases of the Qwen2 family, an lm_head of its own. Every projection
and the lm_head are int4 as the configuration states (quant.py), derived
here from the same bf16 weights the port quantizes; the embedding table is
the bf16 one. No cache and no kernel: a causal forward over the prompt and
the served tokens gives the logits of every position, which a prefill and
the decode steps through a cache must reproduce."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .attention import plain_attention
from .quant import int4_matmul, quantize_weight_int4


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn_dim: int
    rope_theta: float
    rms_eps: float
    attn_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def rms_norm(x, w, eps):
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] at positions [S], rotate-half."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    angles = positions[None, :, None].float() * inv_freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class Decoder:
    """The decoder of an HF-named state dict (`model.embed_tokens`,
    `model.layers.{i}.*`, `model.norm`, `lm_head`), built layer by layer
    so that only the int4 weights stay."""

    def __init__(self, cfg: DecoderConfig, sd: dict, device):
        self.cfg = cfg
        # the activations' integer range in the int4 products: int8 as the
        # port's K2; the control's 7 is int4, the step below
        self.act_qmax = 127
        f32 = lambda t: t.to(device, torch.float32)
        self.embed = sd["model.embed_tokens.weight"].to(device)
        self.norm = f32(sd["model.norm.weight"])
        self.lm_head = quantize_weight_int4(
            sd["lm_head.weight"].to(device).t())
        self.layers = []
        for i in range(cfg.layers):
            p = f"model.layers.{i}."
            layer = {"in_norm": f32(sd[p + "input_layernorm.weight"]),
                     "post_norm": f32(sd[p + "post_attention_layernorm.weight"])}
            for name in PROJ:
                layer[name] = quantize_weight_int4(
                    sd[p + name + ".weight"].to(device).t())
                b = sd.get(p + name + ".bias")
                layer[name + ".bias"] = None if b is None else f32(b)
            self.layers.append(layer)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.to(self.embed.device), self.embed).float()

    def _proj(self, layer, name, x):
        y = int4_matmul(x, layer[name], self.act_qmax)
        b = layer[name + ".bias"]
        return y if b is None else y + b

    def logits(self, embeds: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """embeds [S, D] -> fp32 logits [len(at), vocab] at positions `at`."""
        cfg = self.cfg
        s = embeds.shape[0]
        hd, rep = cfg.head_dim, cfg.heads // cfg.kv_heads
        x = embeds.float()[None]
        pos = torch.arange(s, device=x.device)
        for layer in self.layers:
            h = rms_norm(x, layer["in_norm"], cfg.rms_eps)
            q = self._proj(layer, "self_attn.q_proj", h).reshape(1, s, cfg.heads, hd)
            k = self._proj(layer, "self_attn.k_proj", h).reshape(1, s, cfg.kv_heads, hd)
            v = self._proj(layer, "self_attn.v_proj", h).reshape(1, s, cfg.kv_heads, hd)
            q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
            o = plain_attention(q, k.repeat_interleave(rep, dim=2),
                                v.repeat_interleave(rep, dim=2), causal=True)
            x = x + self._proj(layer, "self_attn.o_proj", o.reshape(1, s, -1))
            h = rms_norm(x, layer["post_norm"], cfg.rms_eps)
            gate = self._proj(layer, "mlp.gate_proj", h)
            up = self._proj(layer, "mlp.up_proj", h)
            x = x + self._proj(layer, "mlp.down_proj", F.silu(gate) * up)
        x = rms_norm(x[0, at], self.norm, cfg.rms_eps)
        return int4_matmul(x, self.lm_head, self.act_qmax)
