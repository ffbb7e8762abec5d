"""Tensor-parallel sharding of the Llama decoder
(rsvldm_tpu/parallel/llama_sharding.py), as explicit Megatron-style shards.

JAX annotates the parameter tree and XLA places the collectives; here each
rank keeps its slice of every sharded tensor and the decoder's forward
(models/vlm/llama.py, `TensorParallel`) runs the collectives itself:

- column-parallel (output features split): q/k/v/gate/up projections and
  the lm_head, so each rank holds heads / n attention heads and kv_heads / n
  kv heads (K1 runs at H / n heads in the prefill);
- row-parallel (input features split): o_proj and down_proj, the partial
  products summed over the group. int8: the per-token activation absmax
  is all-reduced (MAX) before the shard quantizes its slice, and the int32
  accumulators are summed, so the result is the unsharded one bit for bit.
  int4: the 128-groups align with the shards, K2 writes fp32 partials, and
  they are summed in fp32 before the cast;
- vocab-parallel: embed_tokens (a masked local lookup, then a sum) and the
  lm_head's logits gathered over the group (Gemma's tied head reads the
  same vocab shard);
- expert-parallel: the stacked MoE experts; every rank runs its experts on
  every token and the routed sum is reduced;
- int8 per-output scales follow the kernel's output split; int4 `packed`
  and `scale` split along `in` for row-parallel, the packed planes
  repacked for the local rows.

`llama_param_spec` names each split as JAX's PartitionSpec does, keyed by
the port's parameter names and in the port's layouts (nn.Linear weights
are [out, in], QDense / Q4Dense buffers [in, out] as JAX's). A split that
does not divide is replicated, as in JAX; the port decides it per part
(the attention, the FFN, the vocabulary, the experts), because a rank's
heads must be whole: one leaf of a part that does not divide replicates
the part.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.vlm.llama import (KVCache, LlamaModel, Q4Dense, QDense,
                                TensorParallel)
from ..ops.quant import pack_int4, unpack_int4

_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")
_INT4_GROUP = 128  # quantize_llama_'s default group


def llama_param_spec(name: str, t: torch.Tensor, axis: str = "data") -> tuple:
    """The split of parameter / buffer `name` of a LlamaModel, as a
    PartitionSpec-like tuple over t's dims (None: not split)."""
    rep = (None,) * t.dim()
    parts = name.split(".")
    mod, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if t.dim() == 3 and leaf.startswith("experts_"):
        return (axis, None, None)
    linear = leaf in ("weight", "bias") and t.dim() in (1, 2)
    col = any(mod.endswith(k) for k in _COL) or mod == "lm_head"
    row = any(mod.endswith(k) for k in _ROW)
    if mod == "embed_tokens" and t.dim() == 2:
        return (axis, None)
    if linear and mod not in ("embed_tokens",):
        if col:
            return (axis,) + (None,) * (t.dim() - 1)   # [out, in] / [out]
        if row and leaf == "weight":
            return (None, axis)
        return rep
    if leaf in ("kernel_q", "kernel_q4", "scale") and t.dim() == 2:
        if col:
            return (None, axis)                        # [in(/2|/G), out]
        if row:
            return (axis, None)
    if leaf == "scale" and t.dim() == 1 and col:        # int8 per-output
        return (axis,)
    return rep


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Which parts of the decoder shard over n ranks (the rest replicate)."""
    n: int
    attn: bool
    ffn: bool
    experts: bool
    vocab: bool


def _in_ok(inf: int, n: int, group: int | None) -> bool:
    """A row-parallel split of `inf` inputs: whole, and for int4 whole
    quantization groups and nibble pairs."""
    if inf % n:
        return False
    return group is None or ((inf // n) % group == 0 and (inf // n) % 2 == 0)


def shard_plan(cfg, n: int, int4_group: int | None = None) -> ShardPlan:
    """The parts of a `cfg` decoder that shard over n ranks; int4_group:
    the int4 quantization group of the weights, if int4."""
    hd = cfg.head_dim
    attn = (cfg.heads % n == 0 and cfg.kv_heads % n == 0
            and _in_ok(cfg.heads * hd, n, int4_group))
    if cfg.num_experts:
        sh = cfg.shared_expert_dim
        ffn = bool(sh) and _in_ok(sh, n, int4_group)
        experts = cfg.num_experts % n == 0
    else:
        ffn, experts = _in_ok(cfg.ffn_dim, n, int4_group), False
    return ShardPlan(n, attn, ffn, experts, cfg.vocab_size % n == 0)


def _part_on(name: str, plan: ShardPlan) -> bool:
    if ".self_attn." in name:
        return plan.attn
    if ".experts_" in name or name.startswith("experts_"):
        return plan.experts
    if ".mlp." in name or ".block_sparse_moe." in name:
        return plan.ffn
    if "embed_tokens" in name or name.startswith("lm_head"):
        return plan.vocab
    return False


def shard_tensor(name: str, t: torch.Tensor, plan: ShardPlan,
                 rank: int) -> torch.Tensor:
    """Rank `rank`'s shard of the full tensor `name` (a fresh, contiguous
    tensor; the full one is not kept alive). int4 row-parallel planes are
    unpacked, sliced along `in` and packed again."""
    spec = llama_param_spec(name, t)
    if not _part_on(name, plan) or all(a is None for a in spec):
        return t
    dim = next(i for i, a in enumerate(spec) if a is not None)
    n = plan.n
    if name.endswith("kernel_q4") and dim == 0:
        full = unpack_int4(t)
        per = full.shape[0] // n
        return pack_int4(full[rank * per:(rank + 1) * per]).contiguous()
    if t.shape[dim] % n:
        raise ValueError(f"shard_tensor: {name} {tuple(t.shape)} dim {dim} "
                         f"does not split over {n}")
    per = t.shape[dim] // n
    return t.narrow(dim, rank * per, per).clone(
        memory_format=torch.contiguous_format)


def shard_llama_params(params: Dict[str, torch.Tensor], cfg, n: int,
                       rank: int, int4_group: int | None = None) -> dict:
    """{name: full tensor} -> {name: rank's shard} under `shard_plan`."""
    plan = shard_plan(cfg, n, int4_group)
    return {k: shard_tensor(k, v, plan, rank) for k, v in params.items()}


def int4_group_of(model: nn.Module) -> int | None:
    """The int4 quantization group of a decoder (None unless int4)."""
    for m in model.modules():
        if isinstance(m, Q4Dense):
            return 2 * m.kernel_q4.shape[0] // m.scale.shape[0]
    return None


@torch.no_grad()
def shard_module_(module: nn.Module, prefix: str, plan: ShardPlan,
                  rank: int) -> nn.Module:
    """Replace every parameter and buffer of `module` (named `prefix` +
    its own name inside the decoder) by its shard, in place."""
    for sub_name, sub in list(module.named_modules()):
        base = prefix + (sub_name + "." if sub_name else "")
        for leaf, p in list(sub._parameters.items()):
            if p is not None:
                sub._parameters[leaf] = nn.Parameter(
                    shard_tensor(base + leaf, p.data, plan, rank),
                    requires_grad=p.requires_grad)
        for leaf, b in list(sub._buffers.items()):
            if b is not None:
                sub._buffers[leaf] = shard_tensor(base + leaf, b, plan, rank)
    return module


def set_tensor_parallel(model: LlamaModel, plan: ShardPlan,
                        tp: TensorParallel) -> LlamaModel:
    """Point the forward of a sharded decoder at its group: local head
    counts in each block's config, and the group on each sharded part."""
    cfg, n = model.cfg, plan.n
    local = dataclasses.replace(cfg, heads=cfg.heads // n,
                                kv_heads=cfg.kv_heads // n,
                                head_dim_cfg=cfg.head_dim)
    for block in model.model.layers:
        if plan.attn:
            block.cfg = local
            block.tp_attn = tp
        ffn = getattr(block, block.ffn_name)
        if cfg.num_experts:
            if plan.experts:
                ffn.tp = tp
            if plan.ffn:
                ffn.shared_expert.tp = tp
        elif plan.ffn:
            ffn.tp = tp
    model.tp = tp
    model.tp_vocab = tp if plan.vocab else None
    return model


def tensor_parallel(group) -> TensorParallel:
    return TensorParallel(group, dist.get_rank(group),
                          dist.get_world_size(group))


def shard_llama_(model: LlamaModel, group) -> LlamaModel:
    """Shard a whole (full, possibly quantized) decoder over `group` in
    place: each rank keeps its slices, and the forward runs TP. A group of
    one leaves the decoder as it is (no `tp`), so that a mesh of one runs
    the unsharded forward and keeps its captured decode graphs."""
    tp = tensor_parallel(group)
    if tp.size == 1:
        return model
    plan = shard_plan(model.cfg, tp.size, int4_group_of(model))
    shard_module_(model, "", plan, tp.rank)
    return set_tensor_parallel(model, plan, tp)


def shard_lora(lora: dict, plan: ShardPlan, rank: int) -> dict:
    """Rank `rank`'s slices of LoRA adapters {module path: {"a": [in, r],
    "b": [r, out]}} on a decoder sharded by `plan`: a column-parallel
    projection keeps the whole `a` and its columns of `b` (its outputs), a
    row-parallel one its rows of `a` (its inputs) and the whole `b`; the
    adapters of a part that is not sharded stay whole. Fresh contiguous
    tensors: the full ones are not kept alive."""
    out = {}
    for path, ab in lora.items():
        proj = path.rsplit(".", 1)[-1]
        col, row = proj in _COL, proj in _ROW
        if not (col or row) or not _part_on(path + ".weight", plan):
            out[path] = dict(ab)
            continue
        name, dim = ("b", 1) if col else ("a", 0)
        t = ab[name]
        if t.shape[dim] % plan.n:
            raise ValueError(f"shard_lora: {path}.{name} {tuple(t.shape)} "
                             f"does not split over {plan.n}")
        per = t.shape[dim] // plan.n
        out[path] = {**ab, name: t.narrow(dim, rank * per, per).clone(
            memory_format=torch.contiguous_format)}
    return out


def shard_kv_cache(cache: KVCache, n: int, rank: int) -> KVCache:
    """A KV cache [L, B, T, kvh, hd] (and the int8 cache's scale planes
    [L, B, T, kvh]) split over kv heads (axis 3); kv heads that do not
    divide stay whole, as in JAX."""
    def cut(x: Optional[torch.Tensor]):
        if x is None or x.shape[3] % n:
            return x
        per = x.shape[3] // n
        return x.narrow(3, rank * per, per).clone(
            memory_format=torch.contiguous_format)
    return KVCache(*(cut(t) for t in (cache.k, cache.v, cache.k_scale,
                                      cache.v_scale)))


def _children(model: LlamaModel):
    """(parent, attribute, decoder name) of each top-level part, in the
    order of the model's parameters (the order seeded init draws in)."""
    dec = model.model
    out = [(dec, "embed_tokens", "model.embed_tokens")]
    out += [(dec.layers, str(i), f"model.layers.{i}")
            for i in range(len(dec.layers))]
    out.append((dec, "norm", "model.norm"))
    if model.lm_head is not None:
        out.append((model, "lm_head", "lm_head"))
    return out


@torch.no_grad()
def build_sharded_llama(cfg, fill, group, device, dtype,
                        quant: str | None = None) -> LlamaModel:
    """This rank's shard of a decoder, built part by part so that a rank
    never holds more than one full part: each part (the embedding, a
    block, the norm, the lm_head) is materialised on `device` in `dtype`,
    filled by `fill(name, module)` (seeded draws or a state dict),
    quantized as quantize_llama_ does by default (`quant`: int4 in groups
    of 128, the embedding narrowed to bf16), then cut to this rank's
    shard. The result equals shard_llama_ of the whole model built the same
    way; over a group of one it is the whole decoder, without `tp`."""
    from ..models.vlm.llama import quantize_linears_
    if quant and cfg.num_experts:
        raise NotImplementedError("weight-only quantization does not cover "
                                  "MoE expert stacks (as in JAX)")
    tp = tensor_parallel(group)
    plan = shard_plan(cfg, tp.size, _INT4_GROUP if quant == "int4" else None)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    model = model.to(dtype=dtype)
    for parent, attr, name in _children(model):
        part = getattr(parent, attr).to_empty(device=device)
        fill(name, part)
        part.eval().requires_grad_(False)
        if quant:
            holder = nn.Module()
            holder.add_module(attr if attr.isidentifier() else "block", part)
            quantize_linears_(holder, quant, _INT4_GROUP)
            part = next(iter(holder.children()))
            if attr == "embed_tokens":
                part.weight = nn.Parameter(part.weight.to(torch.bfloat16),
                                           requires_grad=False)
        if tp.size > 1:
            shard_module_(part, name + ".", plan, tp.rank)
        if isinstance(parent, nn.ModuleList):
            parent[int(attr)] = part
        else:
            setattr(parent, attr, part)
    model.eval().requires_grad_(False)
    return set_tensor_parallel(model, plan, tp) if tp.size > 1 else model
