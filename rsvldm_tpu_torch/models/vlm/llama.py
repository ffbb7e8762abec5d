"""Llama-3 decoder with a KV cache (rsvldm_tpu/models/vlm/llama.py).

Parameter names are HF LlamaForCausalLM's (`model.embed_tokens`,
`model.layers.{i}.self_attn.{q,k,v,o}_proj`, `.mlp.{gate,up,down}_proj`,
`.input_layernorm`, `.post_attention_layernorm`, `model.norm`, `lm_head`),
the names convert_llama reads. RMSNorm with fp32 statistics, rotate-half
RoPE, GQA, SwiGLU, an lm_head of its own or, with `tie_lm_head`, the
embedding table's transpose (JAX's `embed_tokens.attend`).

One forward serves prefill and decode: new tokens' K/V are written in place
into a preallocated [L, B, T, kv_heads, head_dim] cache (the JAX package
returns a new cache; here the caller's is updated and returned). The cache
holds detached values, so it never keeps an autograd graph alive; training
passes no cache at all and nothing is written. A prefill from position 0
attends through ops/attention.py after the GQA repeat, so it reaches K1 on
CUDA at 1024 tokens and more (the fused kernel in its backward); every
other call (decode) is a grouped einsum against the unrepeated cache masked by
absolute position, and refuses to be differentiated. A decode's write
position is a long tensor, 0-d or one per row ([B]): the K/V go in by
`index_copy_` and RoPE and the mask read the tensor, so the host never
reads a position and a decode step can be captured as a CUDA graph.

Weight-only quantization (`quantize_llama_`) swaps each projection and the
lm_head for QDense (int8) or Q4Dense (int4) module by module, freeing each
dense weight as it goes, and narrows the embedding table to bf16 as the JAX
captioner does. Their products have a straight-through backward (QLoRA).

LoRA (training/vlm_trainer.py): `forward(..., lora=...)` takes adapters by
module path, {"model.layers.{i}.self_attn.q_proj": {"a": [in, r],
"b": [r, out]}, ...}, with the scale already folded into b. QDense and
Q4Dense add the runtime branch y += (x @ a) @ b in fp32 (JAX `_maybe_lora`);
a dense nn.Linear folds the adapter into its weight, W + (a @ b)^T (JAX
`apply_lora`). `cfg.remat` recomputes each block in the backward
(non-reentrant torch.utils.checkpoint, JAX `nn.remat`).

Not ported yet: the other families' knobs, MoE, sliding windows and the
int8 KV cache; their config fields raise when set.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import attention
from ...ops.quant import (Int4Linear, QuantizedLinear, int4_matmul_ste,
                          int8_matmul_ste, quantize_weight, quantize_weight_int4)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    # recompute each block in the backward (gradient checkpointing)
    remat: bool = False
    # logits from the embedding table (HF tie_word_embeddings): no lm_head
    tie_lm_head: bool = False
    # not ported yet: set away from their defaults they raise
    sliding_window: int | None = None
    kv_quant: bool = False
    num_experts: int = 0
    head_dim_cfg: int = 0

    def __post_init__(self):
        for name, default in (("sliding_window", None), ("kv_quant", False),
                              ("num_experts", 0), ("head_dim_cfg", 0)):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"LlamaConfig.{name} is not ported yet (queued with the "
                    "other families, MoE and the int8 KV cache)")

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


LLAMA3_8B_CONFIG = LlamaConfig()


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, T, kv_heads, head_dim]
    v: torch.Tensor

    @classmethod
    def init(cls, cfg: LlamaConfig, batch: int, max_len: int,
             dtype=torch.float32, device=None) -> "KVCache":
        shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention (HF Llama).
    x [B, S, H, D]; positions [S] or [B, S]."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None]
    angles = positions[..., None].float() * inv_freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(x.dtype)


def _maybe_lora(x, y, lora):
    """The runtime low-rank branch: y + ((x @ a) @ b) in fp32, b carrying
    the adapter scale."""
    if lora is None:
        return y
    return y + ((x.float() @ lora["a"]) @ lora["b"]).to(y.dtype)


class QDense(nn.Module):
    """int8 weight storage (JAX QDense): buffers kernel_q int8 [in, out],
    scale fp32 [out]; returns the input's dtype."""

    def __init__(self, ql: QuantizedLinear):
        super().__init__()
        self.register_buffer("kernel_q", ql.q)
        self.register_buffer("scale", ql.scale)

    def forward(self, x, lora=None):
        y = int8_matmul_ste(x, QuantizedLinear(self.kernel_q, self.scale), x.dtype)
        return _maybe_lora(x, y, lora)


class Q4Dense(nn.Module):
    """int4 weight storage (JAX Q4Dense): buffers kernel_q4 int8 [in/2, out]
    (plane-packed nibbles), scale fp32 [in/group, out]."""

    def __init__(self, ql: Int4Linear):
        super().__init__()
        self.register_buffer("kernel_q4", ql.packed)
        self.register_buffer("scale", ql.scale)

    def forward(self, x, lora=None):
        y = int4_matmul_ste(x, Int4Linear(self.kernel_q4, self.scale), x.dtype)
        return _maybe_lora(x, y, lora)


def project(mod: nn.Module, x, lora=None):
    """One projection with an optional adapter: the runtime branch for
    QDense / Q4Dense, the fold-in W + (a @ b)^T for a dense nn.Linear."""
    if lora is None:
        return mod(x)
    if isinstance(mod, nn.Linear):
        w = mod.weight + (lora["a"] @ lora["b"]).t().to(mod.weight.dtype)
        return F.linear(x, w, mod.bias)
    return mod(x, lora)


class _Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.dim, cfg.heads * hd, bias=False)
        self.k_proj = nn.Linear(cfg.dim, cfg.kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(cfg.dim, cfg.kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.heads * hd, cfg.dim, bias=False)


class _MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False)
        self.up_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False)
        self.down_proj = nn.Linear(cfg.ffn_dim, cfg.dim, bias=False)

    def forward(self, h, lora=None):
        lora = lora or {}
        gate = project(self.gate_proj, h, lora.get("gate_proj"))
        up = project(self.up_proj, h, lora.get("up_proj"))
        return project(self.down_proj, F.silu(gate) * up, lora.get("down_proj"))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x, cache_k, cache_v, start_pos, lora=None):
        """x [B, S, D], new tokens at positions start_pos..start_pos+S-1;
        start_pos the Python int 0 for a prefill, else a long tensor, 0-d
        or [B] (one position per row), or an int; cache_k/v [B, T, kvh,
        hd], written in place (detached), or None for a prefill from 0
        that keeps no cache; lora: this block's adapters by projection
        name."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, kvh = cfg.head_dim, cfg.kv_heads
        rep = cfg.heads // kvh
        a = self.self_attn
        lora = lora or {}
        prefill = s > 1 and isinstance(start_pos, int) and start_pos == 0
        if cache_k is None and not prefill:
            raise ValueError("LlamaBlock: decode needs a KV cache")
        h = self.input_layernorm(x)
        q = project(a.q_proj, h, lora.get("q_proj")).reshape(b, s, cfg.heads, hd)
        k = project(a.k_proj, h, lora.get("k_proj")).reshape(b, s, kvh, hd)
        v = project(a.v_proj, h, lora.get("v_proj")).reshape(b, s, kvh, hd)
        if prefill:
            positions = torch.arange(s, device=x.device)
        else:
            # [B, S]: the host never reads a position, so a decode step
            # can be captured once and replayed
            pos = torch.as_tensor(start_pos, device=x.device).reshape(-1, 1)
            positions = (pos + torch.arange(s, device=x.device)).expand(b, s)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if prefill:
            if cache_k is not None:
                with torch.no_grad():
                    cache_k[:, :s] = k.to(cache_k.dtype)
                    cache_v[:, :s] = v.to(cache_v.dtype)
            # prefill: no history; the GQA repeat is paid once here
            kk = k.repeat_interleave(rep, dim=2).to(q.dtype)
            vv = v.repeat_interleave(rep, dim=2).to(q.dtype)
            o = attention(q, kk, vv, causal=True).to(x.dtype)
        else:
            if torch.is_grad_enabled() and x.requires_grad:
                raise NotImplementedError(
                    "LlamaBlock: gradients through the KV-cache decode path "
                    "are not ported (training runs a prefill from 0)")
            t = cache_k.shape[1]
            # row r's position p goes to slot r * T + p of the flat cache
            slots = (torch.arange(b, device=x.device)[:, None] * t
                     + positions).reshape(-1)
            with torch.no_grad():
                cache_k.view(b * t, kvh, hd).index_copy_(
                    0, slots, k.reshape(b * s, kvh, hd).to(cache_k.dtype))
                cache_v.view(b * t, kvh, hd).index_copy_(
                    0, slots, v.reshape(b * s, kvh, hd).to(cache_v.dtype))
            qg = q.reshape(b, s, kvh, rep, hd)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                                  cache_k.float()) / (hd ** 0.5)
            k_pos = torch.arange(t, device=x.device)
            mask = k_pos <= positions[:, :, None]  # [B, S, T]
            logits = logits.masked_fill(~mask[:, None, None], -1e30)
            probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
            o = torch.einsum("bgrqk,bkgd->bqgrd", probs.float(), cache_v.float())
            o = o.reshape(b, s, cfg.heads, hd).to(x.dtype)
        x = x + project(a.o_proj, o.reshape(b, s, cfg.heads * hd),
                        lora.get("o_proj"))
        return x + self.mlp(self.post_attention_layernorm(x), lora)


class _Decoder(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig = LLAMA3_8B_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.model = _Decoder(cfg)
        self.lm_head = (None if cfg.tie_lm_head
                        else nn.Linear(cfg.dim, cfg.vocab_size, bias=False))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the embedding table may be narrower)."""
        return self.model.norm.weight.dtype

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(tokens).to(self.dtype)

    def forward(self, embeds: torch.Tensor, cache: KVCache | None = None,
                start_pos: int | torch.Tensor = 0, lora: dict | None = None,
                logits_at: torch.Tensor | None = None):
        """embeds [B, S, D] -> (fp32 logits [B, S, vocab], the cache).
        start_pos: the Python int 0 for a prefill, else the write position
        as a long tensor, 0-d or [B], or an int (LlamaBlock.forward).
        cache None: a prefill from 0 that writes no cache (training).
        lora: adapters by module path (module docstring).
        logits_at: a long tensor [B] of positions; the final norm and the
        lm_head then run on those rows alone and the logits are
        [B, 1, vocab]. Every op after the last block is per token (the
        quantized products quantize each row on its own), so they equal
        the full logits at those positions."""
        x = embeds.to(self.dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.model.layers):
            ck, cv = (None, None) if cache is None else (cache.k[i], cache.v[i])
            layer_lora = _layer_lora(lora, i)
            if remat:
                x = checkpoint(block, x, ck, cv, start_pos, layer_lora,
                               use_reentrant=False)
            else:
                x = block(x, ck, cv, start_pos, layer_lora)
        if logits_at is not None:
            x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
        x = self.model.norm(x)
        if self.lm_head is None:
            # tied: x @ embedding^T in the wider of the two dtypes (JAX attend)
            w = self.model.embed_tokens.weight
            dt = torch.promote_types(x.dtype, w.dtype)
            return F.linear(x.to(dt), w.to(dt)).float(), cache
        return self.lm_head(x).float(), cache


def _layer_lora(lora: dict | None, i: int) -> dict | None:
    """Block i's adapters by projection name."""
    if not lora:
        return None
    out = {}
    for sub in ("self_attn", "mlp"):
        prefix = f"model.layers.{i}.{sub}."
        out.update({path[len(prefix):]: ab for path, ab in lora.items()
                    if path.startswith(prefix)})
    return out or None


_QUANT_MODULES = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj", "lm_head")


@torch.no_grad()
def quantize_llama_(model: LlamaModel, mode: str = "int8", group: int = 128,
                    embed_dtype=torch.bfloat16) -> LlamaModel:
    """In place: every `_QUANT_MODULES` nn.Linear becomes QDense (int8,
    per-output-channel) or Q4Dense (int4, per (group, out)), one module at a
    time so that only one dense weight is widened at once; the embedding
    table is narrowed to `embed_dtype`."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_llama_: mode {mode!r}")
    # (parent, name) pairs only: holding the Linear modules themselves would
    # keep every dense weight alive to the end
    targets = [(parent, name) for parent in model.modules()
               for name, child in parent.named_children()
               if name in _QUANT_MODULES and isinstance(child, nn.Linear)]
    for parent, name in targets:
        kernel = getattr(parent, name).weight.t()  # [in, out], the JAX layout
        setattr(parent, name,
                Q4Dense(quantize_weight_int4(kernel, group)) if mode == "int4"
                else QDense(quantize_weight(kernel)))
        del kernel
    emb = model.model.embed_tokens
    emb.weight = nn.Parameter(emb.weight.to(embed_dtype), requires_grad=False)
    return model
