"""Llama-family decoders with a KV cache (rsvldm_tpu/models/vlm/llama.py).

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

The int8 KV cache (`LlamaConfig.kv_quant`, JAX llama.py:115-130,
322-352): `KVCache.init` then holds int8 K/V and fp32 scale planes
`k_scale` / `v_scale` [L, B, T, kv_heads]. Each new token's K/V is
quantized per (position, kv head) by absmax / 127 + 1e-8 and round half
to even; a prefill from 0 still attends with the unquantized K/V (K1),
every other call dequantizes the cache (k * k_scale) before its einsum.
A block follows the cache it is given: scale planes mean int8.

The other families are config knobs, as in JAX: `attn_bias` (Qwen2: q/k/v
carry biases), `sliding_window` (Mistral: keys older than the window are
masked; such a model never takes K1, even in a prefill from 0, because
the window is not K1's mask), `norm_plus_one`, `act="gelu_tanh"`,
`scale_embeds`, `tie_lm_head` and `head_dim_cfg` (Gemma: heads of 256 that
are not dim // heads, so q/k/v/o and the cache are sized by heads *
head_dim), and the sparse MoE FFN (`num_experts`: Mixtral, and Qwen2-MoE
with its sigmoid-gated shared expert; `MoEFFN`). An MoE block keeps its
experts stacked ([E, f, d] in the checkpoint's [out, in] layout) and runs
every expert on every token as JAX's dense mix does; its state dict reads
and writes the reference's per-expert names: Mixtral's
`block_sparse_moe.{gate, experts.{e}.w1/w2/w3}` without a shared expert,
Qwen2-MoE's `mlp.{gate, experts.{e}.{gate,up,down}_proj, shared_expert.*,
shared_expert_gate}` with one. Weight-only quantization refuses MoE, as
JAX does: it would leave the expert stacks wide.

Tensor parallelism (parallel/llama_sharding.py): a sharded decoder keeps
its slices and a `TensorParallel` group on each sharded part. A block's
attention then runs its local heads (its `cfg` holds the local counts)
and sums o_proj's partial products over the group; the FFN sums
down_proj's (`row_parallel`); an MoE block runs its experts and sums the
routed mix; the embedding is a masked lookup of the local vocabulary rows
summed over the group, and the logits of the local lm_head rows are
gathered. LoRA adapters are not taken by a sharded decoder.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import attention
from ...ops.quant import (Int4Linear, QuantizedLinear, act_absmax, int4_matmul,
                          int4_matmul_ste, int8_acc, int8_apply_scales,
                          int8_matmul_ste, quantize_acts, quantize_weight,
                          quantize_weight_int4)
from ...parallel.distributed import ReduceOp, all_gather, all_reduce


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
    # the int8 KV cache (KVCache.init): half the cache bytes of bf16
    kv_quant: bool = False
    # family knobs (JAX llama.py:39-45, 70-81)
    attn_bias: bool = False        # Qwen2: q/k/v projections carry bias
    sliding_window: int | None = None  # Mistral: local attention window
    norm_plus_one: bool = False    # Gemma: y = x_norm * (1 + w)
    act: str = "silu"              # Gemma: "gelu_tanh"
    scale_embeds: bool = False     # Gemma: embeds *= sqrt(dim)
    num_experts: int = 0           # 0 = dense FFN
    experts_per_tok: int = 2       # Mixtral top-2; Qwen2-MoE top-4
    moe_ffn_dim: int | None = None     # per-expert FFN width (def: ffn_dim)
    norm_topk_prob: bool = True    # Mixtral: renormalize top-k weights
    shared_expert_dim: int | None = None  # Qwen2-MoE sigmoid-gated shared FFN
    head_dim_cfg: int = 0          # Gemma-7B: 256, not dim // heads

    def __post_init__(self):
        if self.act not in ("silu", "gelu_tanh"):
            raise ValueError(f"LlamaConfig.act {self.act!r}: silu or gelu_tanh")

    @property
    def head_dim(self) -> int:
        return self.head_dim_cfg or self.dim // self.heads

    @property
    def moe_layout(self) -> str | None:
        """The reference's MoE weight names: Qwen2-MoE's with a shared
        expert, Mixtral's without."""
        if not self.num_experts:
            return None
        return "qwen2_moe" if self.shared_expert_dim else "mixtral"


LLAMA3_8B_CONFIG = LlamaConfig()
QWEN2_7B_CONFIG = LlamaConfig(vocab_size=152064, dim=3584, layers=28,
                              heads=28, kv_heads=4, ffn_dim=18944,
                              rope_theta=1000000.0, rms_eps=1e-6,
                              attn_bias=True)
MISTRAL_7B_CONFIG = LlamaConfig(vocab_size=32000, dim=4096, layers=32,
                                heads=32, kv_heads=8, ffn_dim=14336,
                                rope_theta=10000.0, rms_eps=1e-5,
                                sliding_window=4096)
GEMMA_7B_CONFIG = LlamaConfig(vocab_size=256000, dim=3072, layers=28,
                              heads=16, kv_heads=16, ffn_dim=24576,
                              rope_theta=10000.0, rms_eps=1e-6,
                              norm_plus_one=True, scale_embeds=True,
                              tie_lm_head=True, act="gelu_tanh",
                              head_dim_cfg=256)
MIXTRAL_8X7B_CONFIG = LlamaConfig(vocab_size=32000, dim=4096, layers=32,
                                  heads=32, kv_heads=8, ffn_dim=14336,
                                  rope_theta=1000000.0, rms_eps=1e-5,
                                  num_experts=8, experts_per_tok=2)
QWEN2_MOE_A2_7B_CONFIG = LlamaConfig(vocab_size=151936, dim=2048, layers=24,
                                     heads=16, kv_heads=16, ffn_dim=5632,
                                     rope_theta=1000000.0, rms_eps=1e-6,
                                     attn_bias=True, num_experts=60,
                                     experts_per_tok=4, moe_ffn_dim=1408,
                                     norm_topk_prob=False,
                                     shared_expert_dim=5632)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The group a sharded part of the decoder reduces over."""
    group: object
    rank: int
    size: int


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, T, kv_heads, head_dim] (int8 under kv_quant)
    v: torch.Tensor
    k_scale: torch.Tensor | None = None  # [L, B, T, kv_heads] fp32
    v_scale: torch.Tensor | None = None

    @classmethod
    def init(cls, cfg: LlamaConfig, batch: int, max_len: int,
             dtype=torch.float32, device=None) -> "KVCache":
        """Zeros; int8 K/V with fp32 scale planes when cfg.kv_quant (then
        `dtype` is not used)."""
        shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            z = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)
            return cls(z(shape, torch.int8), z(shape, torch.int8),
                       z(shape[:-1], torch.float32), z(shape[:-1], torch.float32))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def leaves(self) -> list:
        """The cache's tensors, batch on axis 1 in each."""
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale)
                if t is not None]

    def row(self, slot: int) -> "KVCache":
        """Views of batch row `slot` (batch 1): writes into them land in
        this cache."""
        return KVCache(*(None if t is None else t[:, slot:slot + 1]
                         for t in (self.k, self.v, self.k_scale, self.v_scale)))

    def layer(self, i: int) -> tuple:
        """Layer i's (k, v, k_scale, v_scale), the scales None unless int8."""
        return tuple(None if t is None else t[i]
                     for t in (self.k, self.v, self.k_scale, self.v_scale))


def quantize_kv(x: torch.Tensor):
    """Per (position, kv head) absmax int8 (JAX llama.py:322-333): x [..., hd]
    -> (int8 codes, fp32 scales [...]), scale = absmax / 127 + 1e-8, codes
    rounded half to even."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-8
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


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
    """fp32 statistics; scale w, or 1 + w with `plus_one` (Gemma, whose
    weights start at 0)."""

    def __init__(self, dim: int, eps: float = 1e-5, plus_one: bool = False):
        super().__init__()
        self.eps = eps
        self.plus_one = plus_one
        self.weight = nn.Parameter(torch.zeros(dim) if plus_one else torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        w = self.weight.float()
        return (n * (1.0 + w if self.plus_one else w)).to(x.dtype)


def _maybe_lora(x, y, lora):
    """The runtime low-rank branch: y + ((x @ a) @ b) in fp32, b carrying
    the adapter scale."""
    if lora is None:
        return y
    return y + ((x.float() @ lora["a"]) @ lora["b"]).to(y.dtype)


def _add_bias(mod: nn.Module, y):
    """A quantized projection's fp32 bias (Qwen2's q/k/v), added after the
    adapter branch in the output's dtype, as JAX's QDense / Q4Dense."""
    return y if mod.bias is None else y + mod.bias.to(y.dtype)


class QDense(nn.Module):
    """int8 weight storage (JAX QDense): buffers kernel_q int8 [in, out],
    scale fp32 [out] (and an fp32 bias [out]); returns the input's dtype."""

    def __init__(self, ql: QuantizedLinear, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("kernel_q", ql.q)
        self.register_buffer("scale", ql.scale)
        self.register_buffer("bias", bias)

    def forward(self, x, lora=None):
        y = int8_matmul_ste(x, QuantizedLinear(self.kernel_q, self.scale), x.dtype)
        return _add_bias(self, _maybe_lora(x, y, lora))


class Q4Dense(nn.Module):
    """int4 weight storage (JAX Q4Dense): buffers kernel_q4 int8 [in/2, out]
    (plane-packed nibbles), scale fp32 [in/group, out] (and an fp32 bias)."""

    def __init__(self, ql: Int4Linear, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("kernel_q4", ql.packed)
        self.register_buffer("scale", ql.scale)
        self.register_buffer("bias", bias)

    def forward(self, x, lora=None):
        y = int4_matmul_ste(x, Int4Linear(self.kernel_q4, self.scale), x.dtype)
        return _add_bias(self, _maybe_lora(x, y, lora))


def row_parallel(mod: nn.Module, x, tp: TensorParallel):
    """A row-parallel projection's full output on every rank of tp's group:
    x holds this rank's slice of the inputs, `mod` the matching rows of the
    weight. int8: the whole row's absmax (all-reduced MAX) quantizes the
    slice and the exact int32 accumulators are summed, so the result is
    the unsharded product bit for bit; int4: fp32 partials (K2's fp32
    output) summed in fp32, then one cast; dense: partials summed in x's
    dtype."""
    if isinstance(mod, QDense):
        xq, xs = quantize_acts(x, all_reduce(act_absmax(x), tp.group,
                                             ReduceOp.MAX))
        acc = all_reduce(int8_acc(xq, mod.kernel_q), tp.group)
        y = int8_apply_scales(acc, xs, QuantizedLinear(mod.kernel_q, mod.scale),
                              xq.shape[:-1], x.dtype)
    elif isinstance(mod, Q4Dense):
        y = all_reduce(int4_matmul(x, Int4Linear(mod.kernel_q4, mod.scale),
                                   torch.float32), tp.group).to(x.dtype)
    else:
        y = all_reduce(F.linear(x, mod.weight), tp.group)
    return y if mod.bias is None else y + mod.bias.to(y.dtype)


def _no_tp_lora(tp, lora):
    if tp is not None and lora:
        raise NotImplementedError("LoRA adapters on a tensor-parallel "
                                  "decoder are not ported")


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
        hd, bias = cfg.head_dim, cfg.attn_bias
        self.q_proj = nn.Linear(cfg.dim, cfg.heads * hd, bias=bias)
        self.k_proj = nn.Linear(cfg.dim, cfg.kv_heads * hd, bias=bias)
        self.v_proj = nn.Linear(cfg.dim, cfg.kv_heads * hd, bias=bias)
        self.o_proj = nn.Linear(cfg.heads * hd, cfg.dim, bias=False)


def _act(name: str):
    if name == "silu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


class _MLP(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, act: str = "silu"):
        super().__init__()
        self.act = _act(act)
        self.gate_proj = nn.Linear(dim, ffn_dim, bias=False)
        self.up_proj = nn.Linear(dim, ffn_dim, bias=False)
        self.down_proj = nn.Linear(ffn_dim, dim, bias=False)
        self.tp: TensorParallel | None = None

    def forward(self, h, lora=None):
        _no_tp_lora(self.tp, lora)
        lora = lora or {}
        gate = project(self.gate_proj, h, lora.get("gate_proj"))
        up = project(self.up_proj, h, lora.get("up_proj"))
        if self.tp is not None:
            return row_parallel(self.down_proj, self.act(gate) * up, self.tp)
        return project(self.down_proj, self.act(gate) * up, lora.get("down_proj"))


# the reference's per-expert weight names (gate, up, down) by layout
# (rsvldm_tpu/utils/convert_hf.py:293-302)
_EXPERT_NAMES = {"mixtral": ("w1", "w3", "w2"),
                 "qwen2_moe": ("gate_proj", "up_proj", "down_proj")}
_STACKS = ("experts_gate", "experts_up", "experts_down")


class MoEFFN(nn.Module):
    """Sparse-MoE FFN (JAX MoEFFN, llama.py:416-466): an fp32 softmax
    router, top-k experts (renormalized with `norm_topk_prob`), SwiGLU
    experts mixed densely (every expert on every token, the unselected
    weighted 0), plus Qwen2-MoE's sigmoid-gated shared expert. The experts
    are stacked Parameters ([E, f, d], [E, f, d], [E, d, f]); the state
    dict holds them under the reference's per-expert names, and a load
    takes either layout's."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        e, d = cfg.num_experts, cfg.dim
        f = cfg.moe_ffn_dim or cfg.ffn_dim
        self.top_k, self.renorm = cfg.experts_per_tok, cfg.norm_topk_prob
        self.layout = cfg.moe_layout
        self.gate = nn.Linear(d, e, bias=False)  # the router
        self.experts_gate = nn.Parameter(torch.empty(e, f, d))
        self.experts_up = nn.Parameter(torch.empty(e, f, d))
        self.experts_down = nn.Parameter(torch.empty(e, d, f))
        if cfg.shared_expert_dim:
            self.shared_expert = _MLP(d, cfg.shared_expert_dim)
            self.shared_expert_gate = nn.Linear(d, 1, bias=False)
        # expert parallelism: this rank's experts are the stacks' rows
        self.tp: TensorParallel | None = None
        self._register_state_dict_hook(MoEFFN._per_expert_names)
        self._register_load_state_dict_pre_hook(MoEFFN._stack_experts)

    @staticmethod
    def _per_expert_names(module, sd, prefix, _meta):
        for stack, name in zip(_STACKS, _EXPERT_NAMES[module.layout]):
            w = sd.pop(prefix + stack)
            for e in range(w.shape[0]):
                sd[f"{prefix}experts.{e}.{name}.weight"] = w[e]
        return sd

    @staticmethod
    def _stack_experts(sd, prefix, *_):
        for names in _EXPERT_NAMES.values():
            if f"{prefix}experts.0.{names[0]}.weight" not in sd:
                continue
            for stack, name in zip(_STACKS, names):
                keys = []
                while f"{prefix}experts.{len(keys)}.{name}.weight" in sd:
                    keys.append(f"{prefix}experts.{len(keys)}.{name}.weight")
                sd[prefix + stack] = torch.stack([sd.pop(k) for k in keys])

    def forward(self, h, lora=None):
        if lora:
            raise NotImplementedError("MoEFFN: LoRA adapters on the experts "
                                      "are not supported (nor in JAX)")
        b, s, d = h.shape
        e, f = self.experts_gate.shape[:2]
        probs = torch.softmax(self.gate(h).float(), dim=-1)
        topv, topi = probs.topk(self.top_k, dim=-1)
        if self.renorm:
            topv = topv / topv.sum(-1, keepdim=True)
        w = torch.zeros_like(probs).scatter(-1, topi, topv)  # [B, S, E]
        if self.tp is not None:
            w = w[..., self.tp.rank * e:(self.tp.rank + 1) * e]
        x = h.reshape(b * s, d)
        g = F.linear(x, self.experts_gate.reshape(e * f, d)).reshape(b * s, e, f)
        u = F.linear(x, self.experts_up.reshape(e * f, d)).reshape(b * s, e, f)
        a = (F.silu(g) * u).transpose(0, 1)                     # [E, BS, f]
        y = torch.bmm(a, self.experts_down.transpose(1, 2))     # [E, BS, d]
        out = (y * w.reshape(b * s, e).t()[..., None].to(y.dtype)).sum(0)
        if self.tp is not None:
            out = all_reduce(out, self.tp.group)
        out = out.reshape(b, s, d)
        if hasattr(self, "shared_expert"):
            out = out + (torch.sigmoid(self.shared_expert_gate(h))
                         * self.shared_expert(h))
        return out.to(h.dtype)


def _grouped_attention(q, k_all, v_all, positions, window: int | None):
    """The general path (JAX llama.py:368-407): q [B, S, H, hd] at
    `positions` [B, S] against the unrepeated keys / values [B, T, kvh, hd]
    at positions 0..T-1, masked causally (and to the last `window`
    positions), fp32 logits and softmax, probabilities in v's dtype."""
    b, s, heads, hd = q.shape
    t, kvh = k_all.shape[1], k_all.shape[2]
    qg = q.reshape(b, s, kvh, heads // kvh, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          k_all.float()) / (hd ** 0.5)
    k_pos = torch.arange(t, device=q.device)
    mask = k_pos <= positions[:, :, None]  # [B, S, T]
    if window is not None:
        mask = mask & (k_pos > positions[:, :, None] - window)
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v_all.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", probs.float(), v_all.float())
    return o.reshape(b, s, heads, hd)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, cfg.norm_plus_one)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_eps,
                                                cfg.norm_plus_one)
        # the FFN under its reference name: Mixtral's block_sparse_moe, else mlp
        self.ffn_name = ("block_sparse_moe" if cfg.moe_layout == "mixtral"
                         else "mlp")
        setattr(self, self.ffn_name, MoEFFN(cfg) if cfg.num_experts
                else _MLP(cfg.dim, cfg.ffn_dim, cfg.act))
        # the group of a sharded attention (then cfg holds local heads)
        self.tp_attn: TensorParallel | None = None

    def forward(self, x, cache_k, cache_v, start_pos, lora=None,
                cache_ks=None, cache_vs=None):
        """x [B, S, D], new tokens at positions start_pos..start_pos+S-1;
        start_pos the Python int 0 for a prefill, else a long tensor, 0-d
        or [B] (one position per row), or an int; cache_k/v [B, T, kvh,
        hd], written in place (detached), or None for a prefill from 0
        that keeps no cache; cache_ks/vs [B, T, kvh]: the int8 cache's
        scale planes (then cache_k/v hold int8 codes); lora: this block's
        adapters by projection name. A prefill from 0 attends through
        ops/attention.py (K1 on the card at 1024 tokens and more) unless
        the model has a sliding window; every other call takes the
        grouped einsum against the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, kvh = cfg.head_dim, cfg.kv_heads
        rep = cfg.heads // kvh
        a = self.self_attn
        _no_tp_lora(self.tp_attn, lora)
        lora = lora or {}
        prefill = s > 1 and isinstance(start_pos, int) and start_pos == 0
        if cache_k is None and not prefill:
            raise ValueError("LlamaBlock: decode needs a KV cache")
        h = self.input_layernorm(x)
        q = project(a.q_proj, h, lora.get("q_proj")).reshape(b, s, cfg.heads, hd)
        k = project(a.k_proj, h, lora.get("k_proj")).reshape(b, s, kvh, hd)
        v = project(a.v_proj, h, lora.get("v_proj")).reshape(b, s, kvh, hd)
        if prefill:
            positions = torch.arange(s, device=x.device).expand(b, s)
        else:
            # [B, S]: the host never reads a position, so a decode step
            # can be captured once and replayed
            pos = torch.as_tensor(start_pos, device=x.device).reshape(-1, 1)
            positions = (pos + torch.arange(s, device=x.device)).expand(b, s)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        quant = cache_ks is not None
        if cache_k is not None:
            with torch.no_grad():
                if quant:
                    (k_st, k_sc), (v_st, v_sc) = quantize_kv(k), quantize_kv(v)
                else:
                    k_st, v_st = k.to(cache_k.dtype), v.to(cache_v.dtype)
        if prefill and cfg.sliding_window is None:
            if cache_k is not None:
                with torch.no_grad():
                    cache_k[:, :s] = k_st
                    cache_v[:, :s] = v_st
                    if quant:
                        cache_ks[:, :s] = k_sc
                        cache_vs[:, :s] = v_sc
            # prefill: no history; the GQA repeat is paid once here
            kk = k.repeat_interleave(rep, dim=2).to(q.dtype)
            vv = v.repeat_interleave(rep, dim=2).to(q.dtype)
            o = attention(q, kk, vv, causal=True).to(x.dtype)
        elif cache_k is None:
            # a windowed prefill that keeps no cache (training)
            o = _grouped_attention(q, k.to(q.dtype), v.to(q.dtype), positions,
                                   cfg.sliding_window).to(x.dtype)
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
                    0, slots, k_st.reshape(b * s, kvh, hd))
                cache_v.view(b * t, kvh, hd).index_copy_(
                    0, slots, v_st.reshape(b * s, kvh, hd))
                if quant:
                    cache_ks.view(b * t, kvh).index_copy_(
                        0, slots, k_sc.reshape(b * s, kvh))
                    cache_vs.view(b * t, kvh).index_copy_(
                        0, slots, v_sc.reshape(b * s, kvh))
            if quant:
                # dequantized in the compute dtype, as JAX's astype(q.dtype)
                k_eff = (cache_k.float() * cache_ks[..., None]).to(q.dtype)
                v_eff = (cache_v.float() * cache_vs[..., None]).to(q.dtype)
            else:
                k_eff, v_eff = cache_k, cache_v
            o = _grouped_attention(q, k_eff, v_eff, positions,
                                   cfg.sliding_window).to(x.dtype)
        o = o.reshape(b, s, cfg.heads * hd)
        x = x + (project(a.o_proj, o, lora.get("o_proj")) if self.tp_attn is None
                 else row_parallel(a.o_proj, o, self.tp_attn))
        ffn = getattr(self, self.ffn_name)
        return x + ffn(self.post_attention_layernorm(x), lora)


class _Decoder(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, cfg.norm_plus_one)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig = LLAMA3_8B_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.model = _Decoder(cfg)
        self.lm_head = (None if cfg.tie_lm_head
                        else nn.Linear(cfg.dim, cfg.vocab_size, bias=False))
        # tensor parallelism (parallel/llama_sharding.py): the model's group,
        # and the group of the vocab-sharded embedding and lm_head
        self.tp: TensorParallel | None = None
        self.tp_vocab: TensorParallel | None = None

    @property
    def cache_cfg(self) -> LlamaConfig:
        """The config a KV cache of this rank is sized by: the blocks'
        (local kv heads on a sharded attention)."""
        layers = self.model.layers
        return layers[0].cfg if len(layers) else self.cfg

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the embedding table may be narrower)."""
        return self.model.norm.weight.dtype

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype; Gemma's scale by sqrt(dim)
        is taken in fp32 and rounded to that dtype first (JAX llama.py:
        497-501: in bf16, sqrt(3072) = 55.43 becomes 55.5)."""
        tp = self.tp_vocab
        if tp is None:
            e = self.model.embed_tokens(tokens)
        else:
            # the local rows of the table, the other ranks' tokens zero
            w = self.model.embed_tokens.weight
            local = tokens - tp.rank * w.shape[0]
            ok = (local >= 0) & (local < w.shape[0])
            e = F.embedding(local.clamp(0, w.shape[0] - 1), w)
            e = all_reduce(torch.where(ok[..., None], e, torch.zeros_like(e)),
                           tp.group)
        e = e.to(self.dtype)
        if self.cfg.scale_embeds:
            e = e * torch.sqrt(torch.tensor(float(self.cfg.dim))).to(e.dtype)
        return e

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
            ck, cv, cks, cvs = ((None,) * 4 if cache is None else cache.layer(i))
            layer_lora = _layer_lora(lora, i)
            if remat:
                x = checkpoint(block, x, ck, cv, start_pos, layer_lora,
                               cks, cvs, use_reentrant=False)
            else:
                x = block(x, ck, cv, start_pos, layer_lora, cks, cvs)
        if logits_at is not None:
            x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
        x = self.model.norm(x)
        if self.lm_head is None:
            # tied: x @ embedding^T in the wider of the two dtypes (JAX attend)
            w = self.model.embed_tokens.weight
            dt = torch.promote_types(x.dtype, w.dtype)
            logits = F.linear(x.to(dt), w.to(dt)).float()
        else:
            logits = self.lm_head(x).float()
        if self.tp_vocab is not None:
            logits = all_gather(logits, self.tp_vocab.group, dim=-1)
        return logits, cache


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
    time so that only one dense weight is widened at once, its bias kept in
    fp32; the embedding table is narrowed to `embed_dtype`. MoE models
    raise."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_llama_: mode {mode!r}")
    if model.cfg.num_experts:
        raise NotImplementedError(
            "weight-only quantization does not cover MoE expert stacks (as "
            "in JAX): quantizing only the attention projections would leave "
            "most of the weights wide; load MoE families unquantized")
    quantize_linears_(model, mode, group)
    emb = model.model.embed_tokens
    emb.weight = nn.Parameter(emb.weight.to(embed_dtype), requires_grad=False)
    return model


@torch.no_grad()
def quantize_linears_(root: nn.Module, mode: str, group: int = 128) -> nn.Module:
    """quantize_llama_'s module swap under `root` (a whole decoder or one
    of its children), without the embedding's narrowing."""
    # (parent, name) pairs only: holding the Linear modules themselves would
    # keep every dense weight alive to the end
    targets = [(parent, name) for parent in root.modules()
               for name, child in parent.named_children()
               if name in _QUANT_MODULES and isinstance(child, nn.Linear)]
    for parent, name in targets:
        dense = getattr(parent, name)
        kernel = dense.weight.t()  # [in, out], the JAX layout
        bias = None if dense.bias is None else dense.bias.detach().float()
        del dense
        setattr(parent, name,
                Q4Dense(quantize_weight_int4(kernel, group), bias) if mode == "int4"
                else QDense(quantize_weight(kernel), bias))
        del kernel
    return root
