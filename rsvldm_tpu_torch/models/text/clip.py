"""CLIP text transformers: CLIP-L/14 and OpenCLIP ViT-bigG-14
(rsvldm_tpu/models/text/clip.py).

One module, two checkpoint layouts. `openclip=False` names parameters as HF
CLIPTextModel (`text_model.encoder.layers.{i}.self_attn.q_proj`, ...), the
layout rsvldm_tpu/utils/convert_hf.py::convert_hf_clip_text reads;
`openclip=True` as open_clip (`transformer.resblocks.{i}.attn.in_proj_weight`,
`ln_final`, `text_projection`), the layout of convert_openclip_text. Both
return the penultimate hidden state (input of the last block), the last
hidden state, and the pooled vector ln_final(last)[argmax token], projected
by text_projection when the config has one.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.norm import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    context_length: int = 77
    quick_gelu: bool = True     # HF CLIP-L; OpenCLIP bigG uses plain gelu
    use_text_projection: bool = False
    projection_dim: int | None = None
    openclip: bool = False      # parameter layout: open_clip vs HF


CLIP_L_CONFIG = CLIPTextConfig()
OPENCLIP_BIGG_CONFIG = CLIPTextConfig(width=1280, layers=32, heads=20,
                                      quick_gelu=False, use_text_projection=True,
                                      openclip=True)


def _causal_attention(q, k, v, heads: int):
    """q/k/v [B, S, W] -> [B, S, W]; fp32 logits and softmax."""
    b, s, w = q.shape
    hd = w // heads
    q, k, v = (x.reshape(b, s, heads, hd) for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, s, w)


class HFAttention(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, x):
        out = _causal_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                self.heads)
        return self.out_proj(out)


class OpenCLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameter layout: packed in_proj."""

    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * w, w))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * w))
        self.out_proj = nn.Linear(w, w)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        return self.out_proj(_causal_attention(q, k, v, self.heads))


class CLIPBlock(nn.Module):
    """Pre-LN block; LayerNorms in fp32 (eps 1e-5)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        w = cfg.width
        self.openclip = cfg.openclip
        self.quick_gelu = cfg.quick_gelu
        if cfg.openclip:
            self.ln_1 = LayerNorm32(w, eps=1e-5)
            self.attn = OpenCLIPAttention(w, cfg.heads)
            self.ln_2 = LayerNorm32(w, eps=1e-5)
        else:
            self.layer_norm1 = LayerNorm32(w, eps=1e-5)
            self.self_attn = HFAttention(w, cfg.heads)
            self.layer_norm2 = LayerNorm32(w, eps=1e-5)
        fc, proj = ("c_fc", "c_proj") if cfg.openclip else ("fc1", "fc2")
        self.mlp = nn.ModuleDict({fc: nn.Linear(w, 4 * w),
                                  proj: nn.Linear(4 * w, w)})

    def _act(self, x):
        if self.quick_gelu:
            return x * torch.sigmoid(1.702 * x)
        return F.gelu(x)

    def forward(self, x):
        if self.openclip:
            ln1, attn, ln2 = self.ln_1, self.attn, self.ln_2
        else:
            ln1, attn, ln2 = self.layer_norm1, self.self_attn, self.layer_norm2
        dt = x.dtype
        x = x + attn(ln1(x).to(dt))
        fc, proj = self.mlp.values()
        return x + proj(self._act(fc(ln2(x).to(dt))))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.width)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPBlock(cfg) for _ in range(cfg.layers))


class _HFTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm32(cfg.width, eps=1e-5)


class _Resblocks(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(cfg) for _ in range(cfg.layers))


class CLIPTextTransformer(nn.Module):
    """tokens [B, 77] int -> dict(penultimate, last, pooled)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.openclip:
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
            self.positional_embedding = nn.Parameter(
                torch.empty(cfg.context_length, cfg.width).normal_(std=0.01))
            self.transformer = _Resblocks(cfg)
            self.ln_final = LayerNorm32(cfg.width, eps=1e-5)
            if cfg.use_text_projection:
                self.text_projection = nn.Parameter(torch.empty(
                    cfg.width, cfg.projection_dim or cfg.width).normal_(std=0.02))
        else:
            self.text_model = _HFTextModel(cfg)
            if cfg.use_text_projection:
                self.text_projection = nn.Linear(
                    cfg.width, cfg.projection_dim or cfg.width, bias=False)

    def _parts(self):
        if self.cfg.openclip:
            return (self.token_embedding.weight, self.positional_embedding,
                    self.transformer.resblocks, self.ln_final)
        tm = self.text_model
        return (tm.embeddings.token_embedding.weight,
                tm.embeddings.position_embedding.weight, tm.encoder.layers,
                tm.final_layer_norm)

    def forward(self, tokens: torch.Tensor):
        tok_emb, pos_emb, blocks, ln_final = self._parts()
        x = tok_emb[tokens] + pos_emb[None, :tokens.shape[1]]
        penultimate = None
        for i, blk in enumerate(blocks):
            if i == len(blocks) - 1:
                penultimate = x
            x = blk(x)
        last = x
        lnf = ln_final(last)
        eot = tokens.argmax(dim=-1)
        pooled = lnf[torch.arange(tokens.shape[0], device=tokens.device), eot]
        if self.cfg.use_text_projection:
            proj = self.text_projection
            if isinstance(proj, nn.Linear):
                pooled = F.linear(pooled, proj.weight.float())
            else:
                pooled = pooled @ proj.float()
        return dict(penultimate=penultimate, last=last, pooled=pooled)
