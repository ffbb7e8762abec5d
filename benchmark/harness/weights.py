"""The cell's weights, made on the device from --seed in the type they are
served in (bf16), at the scales of the port's bf16 rule for seeded weights
(the JAX pipeline's smoke init): biases 0, norm weights 1, Linear and
Conv2d weights normal times (1 / fan_in)^0.5, every other tensor normal
times 0.02. One family is one torch.randn on the card from a generator
seeded by (seed, family), sliced into its tensors, so the same seed gives
the same weights to the port and, after the window, to the reference.

A configuration may add `"weights": {"bias_std": b, "norm_std": n}`:
biases then draw b times a normal and norm weights 1 + n times a normal
from the same randn (the CPU rehearsal's tiny geometry does, so that a
bias or a norm scale the port dropped shows; the chip cells keep the
port's rule).

Names and shapes are the reference modules' (the port's state-dict names),
read from modules built on the meta device; the captioner's are the
HF LLaVA names `LlavaCaptioner.from_state_dict` reads."""

from __future__ import annotations

import hashlib
from collections.abc import Mapping

import torch
from torch import nn

from reference.norm import GroupNorm32
from reference.pipeline import family_configs, vision_config
from reference.projector import MLPProjector
from reference.vision import CLIPVisionTower

NORMS = (GroupNorm32, nn.LayerNorm, nn.GroupNorm)


def family_seed(seed: int, family: str) -> int:
    h = hashlib.sha256(f"weights/{int(seed)}/{family}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _spreads(spec: dict) -> tuple:
    """(bias rule, norm rule), each (offset, scale) of its normal."""
    w = spec.get("weights", {})
    return (0.0, float(w.get("bias_std", 0.0))), \
        (1.0, float(w.get("norm_std", 0.0)))


def module_plan(module: nn.Module, prefix: str = "",
                spreads=((0.0, 0.0), (1.0, 0.0))) -> list:
    """[(name, shape, (offset, scale))] of a module's parameters: the value
    is offset + scale x a normal (no draw where scale is 0)."""
    bias, norm = spreads
    plan = []
    for name, prm in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        if prm.dim() == 0:
            rule = (0.0, 0.0)
        elif leaf.endswith("bias"):
            rule = bias
        elif isinstance(owner, NORMS):
            rule = norm
        elif (isinstance(owner, (nn.Conv2d, nn.Linear)) and leaf == "weight"
              or leaf == "in_proj_weight"):
            rule = (0.0, (1.0 / prm[0].numel()) ** 0.5)
        else:
            rule = (0.0, 0.02)
        plan.append((prefix + name, tuple(prm.shape), rule))
    return plan


def decoder_plan(tc: dict, spreads=((0.0, 0.0), (1.0, 0.0))) -> list:
    """The HF names of a Llama-family decoder of `text_config` tc."""
    bias_rule, norm_rule = spreads
    d, f, v = tc["hidden_size"], tc["intermediate_size"], tc["vocab_size"]
    hd = d // tc["num_attention_heads"]
    q, kv = tc["num_attention_heads"] * hd, tc["num_key_value_heads"] * hd
    bias = tc.get("attention_bias", False)
    plan = [("model.embed_tokens.weight", (v, d), (0.0, 0.02))]
    for i in range(tc["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (q, d)),
                            ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)),
                            ("self_attn.o_proj", (d, q)),
                            ("mlp.gate_proj", (f, d)), ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            plan.append((p + name + ".weight", shape,
                         (0.0, (1.0 / shape[1]) ** 0.5)))
            if bias and name in ("self_attn.q_proj", "self_attn.k_proj",
                                 "self_attn.v_proj"):
                plan.append((p + name + ".bias", (shape[0],), bias_rule))
        plan += [(p + "input_layernorm.weight", (d,), norm_rule),
                 (p + "post_attention_layernorm.weight", (d,), norm_rule)]
    plan += [("model.norm.weight", (d,), norm_rule),
             ("lm_head.weight", (v, d), (0.0, (1.0 / d) ** 0.5))]
    return plan


def _meta(cls, *args) -> nn.Module:
    with torch.device("meta"):
        return cls(*args)


def family_plan(spec: dict, family: str) -> list:
    spreads = _spreads(spec)
    if family == "llava":
        tower = _meta(CLIPVisionTower, vision_config(spec))
        proj = _meta(MLPProjector, tower.cfg.width,
                     spec["text_config"]["hidden_size"], spec["projector_depth"])
        return (decoder_plan(spec["text_config"], spreads)
                + module_plan(tower, "model.vision_tower.vision_tower.",
                              spreads)
                + module_plan(proj, "model.mm_projector.", spreads)
                + [("model.image_newline",
                    (spec["text_config"]["hidden_size"],), (0.0, 0.02))])
    cls, cfg = family_configs(spec)[family]
    return module_plan(_meta(cls, cfg), spreads=spreads)


@torch.no_grad()
def make(plan: list, seed: int, family: str, device, dtype=torch.bfloat16,
         host: bool = False) -> dict:
    """{name: tensor} of `plan`: one randn over the drawn tensors, sliced.
    With `host`, drawn and scaled on the device as without it, then moved
    to the host, as a deployment's weights sit in host memory mapped from
    their files before the port reads them."""
    n = sum(int(torch.Size(s).numel()) for _, s, (_, scale) in plan if scale)
    gen = torch.Generator(device=device).manual_seed(family_seed(seed, family))
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    views, at = [], 0
    for name, shape, (offset, scale) in plan:
        if not scale:
            continue
        k = int(torch.Size(shape).numel())
        view = flat[at:at + k].view(shape).mul_(scale)
        if offset:
            view.add_(offset)
        views.append((name, at, k, shape))
        at += k
    if host:
        flat = flat.cpu()
    const_device = "cpu" if host else device
    drawn = {name: flat[a:a + k].view(shape) for name, a, k, shape in views}
    return {name: drawn[name] if scale else torch.full(
                shape, offset, device=const_device, dtype=dtype)
            for name, shape, (offset, scale) in plan}


class SeededStateDicts(Mapping):
    """The pipeline families' state dicts, each made when the port asks
    for it (`get`), so that one family's tensors at a time sit beside the
    modules being filled."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.families = tuple(family_configs(spec))

    def __getitem__(self, family):
        if family not in self.families:
            raise KeyError(family)
        return make(family_plan(self.spec, family), self.seed, family,
                    self.device)

    def __iter__(self):
        return iter(self.families)

    def __len__(self):
        return len(self.families)
