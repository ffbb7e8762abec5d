"""LLaVA supervised finetuning with LoRA adapters on a frozen base
(rsvldm_tpu/training/vlm_trainer.py, the QLoRA recipe when the base is int8
or int4).

Adapters live in their own dictionary, keyed by the port's module path:
{"model.layers.{i}.self_attn.q_proj": {"a": [in, r], "b": [r, out]}, ...},
fp32, on the model's device. Only they enter the optimizer; the base's
parameters and buffers never require grad and their bytes never change.
On an fp base each adapter folds into its weight inside the forward
(W + s * (a @ b)^T); on an int8 / int4 base it rides the runtime branch of
QDense / Q4Dense (y += (x @ a) @ (s * b)), and the quantized products have
a straight-through backward. Gradients reach the adapters through K1's
autograd Function (the fused backward kernel) on CUDA at 1024 tokens and
more.

Archives (`save_lora_npz` / `load_lora_npz`) keep the JAX package's keys
(`layer_i/q_proj/a`, `__meta__`), so either package reads the other's;
`load_projector_npz` reads the JAX package's projector archives
(`params/fc0/kernel`, ...).

Not ported yet (ROADMAP item 15): MMTrainer (projector tuning),
DPOTrainer and dpo_loss.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.vlm.llama import Q4Dense, QDense
from ..ops.quant import QuantizedLinear, dequantize_int8, quantize_weight
from ..utils.weights import lora_from_jax, lora_to_jax, params_from_jax

IGNORE_INDEX = -100  # llava/constants.py

Lora = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 16
    # every decoder linear except lm_head, as the reference recipe
    targets: Sequence[str] = ("q_proj", "k_proj", "v_proj", "o_proj",
                              "gate_proj", "up_proj", "down_proj")

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _dims(mod: nn.Module) -> tuple[int, int]:
    if isinstance(mod, nn.Linear):
        return mod.in_features, mod.out_features
    if isinstance(mod, QDense):
        return mod.kernel_q.shape
    return 2 * mod.kernel_q4.shape[0], mod.kernel_q4.shape[1]


def _targets(model: nn.Module, cfg: LoraConfig):
    return [(path, mod) for path, mod in model.named_modules()
            if path.rsplit(".", 1)[-1] in cfg.targets
            and isinstance(mod, (nn.Linear, QDense, Q4Dense))]


def init_lora(model: nn.Module, cfg: LoraConfig,
              generator: torch.Generator | None = None) -> Lora:
    """A ~ U(-1/sqrt(in), 1/sqrt(in)) (PEFT's lora_A init), B = 0, for
    every target projection, drawn in module order from `generator` (a CPU
    generator, default seeded 0) and moved to the model's device. JAX's
    stream cannot be replayed: tests carry its adapters across."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    lora: Lora = {}
    for path, mod in _targets(model, cfg):
        in_f, out_f = _dims(mod)
        dev = next(mod.buffers(), next(mod.parameters(), None)).device
        bound = 1.0 / float(in_f) ** 0.5
        a = (torch.rand((in_f, cfg.r), generator=gen) * 2 - 1) * bound
        lora[path] = {"a": a.to(dev),
                      "b": torch.zeros((cfg.r, out_f), device=dev)}
    return lora


def quant_mode(model: nn.Module) -> str | None:
    """"int8" / "int4" when the model holds quantized projections."""
    for mod in model.modules():
        if isinstance(mod, QDense):
            return "int8"
        if isinstance(mod, Q4Dense):
            return "int4"
    return None


def runtime_lora(lora: Lora, scale: float) -> Lora:
    """The adapters as the model's forward takes them: the scale (alpha/r)
    folded into b, so the branch is just (x @ a) @ b."""
    return {p: {"a": ab["a"], "b": ab["b"] * scale} for p, ab in lora.items()}


def apply_lora(model: nn.Module, lora: Lora, scale: float) -> dict:
    """The model's state dict with every adapter folded into its dense
    weight, W + scale * (a @ b)^T (fp bases)."""
    sd = dict(model.state_dict())
    for path, ab in lora.items():
        w = sd[f"{path}.weight"]
        sd[f"{path}.weight"] = w + (scale * (ab["a"] @ ab["b"])).t().to(w.dtype)
    return sd


def apply_model(model: nn.Module, lora: Lora | None, lora_cfg: LoraConfig,
                embeds: torch.Tensor, cache=None, start_pos: int = 0):
    """One forward for fp and quantized bases: (logits, cache)."""
    if lora is None:
        return model(embeds, cache, start_pos)
    return model(embeds, cache, start_pos,
                 lora=runtime_lora(lora, lora_cfg.scale))


@torch.no_grad()
def export_merged(model: nn.Module, lora: Lora, cfg: LoraConfig) -> dict:
    """A merged state dict for serving without adapters. int8: each
    adapted kernel is dequantized, gets scale * a @ b and is quantized
    again (one more rounding of the delta). int4 kernels are served
    unmerged only."""
    mode = quant_mode(model)
    if mode is None:
        return apply_lora(model, lora, cfg.scale)
    if mode == "int4":
        raise NotImplementedError(
            "int4 merge would re-round group-packed nibbles; serve adapters "
            "unmerged via the runtime branch instead")
    sd = dict(model.state_dict())
    for path, ab in lora.items():
        w = dequantize_int8(QuantizedLinear(sd[f"{path}.kernel_q"],
                                            sd[f"{path}.scale"]))
        ql = quantize_weight(w + cfg.scale * (ab["a"] @ ab["b"]))
        sd[f"{path}.kernel_q"], sd[f"{path}.scale"] = ql.q, ql.scale
    return sd


def preprocess_conversation(prompt_ids: np.ndarray, answer_ids: np.ndarray,
                            eot_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(input_ids, labels): the prompt span masked with IGNORE_INDEX, the
    answer and the closing eot supervised."""
    inp = np.concatenate([prompt_ids, answer_ids, [eot_id]]).astype(np.int32)
    labels = np.full_like(inp, IGNORE_INDEX)
    labels[len(prompt_ids):] = inp[len(prompt_ids):]
    return inp, labels


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy averaged over the supervised targets
    (labels != IGNORE_INDEX); 0 when none is."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    n = (targets != IGNORE_INDEX).sum().clamp_min(1)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="sum")
    return nll / n


def vlm_loss(model: nn.Module, lora: Lora | None, lora_cfg: LoraConfig,
             input_embeds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked next-token loss; input_embeds [B, S, D] already hold the
    spliced image features, labels [B, S] IGNORE_INDEX where unsupervised.
    A prefill from 0 with no KV cache."""
    logits, _ = apply_model(model, lora, lora_cfg, input_embeds)
    return masked_ce(logits, labels)


class VLMTrainer:
    """LoRA finetuning of the decoder: AdamW (optax's adamw with weight
    decay 0) over the adapters only; the base is frozen in place."""

    def __init__(self, model: nn.Module, lora_cfg: LoraConfig = LoraConfig(),
                 lr: float = 2e-4, generator: torch.Generator | None = None,
                 lora: Lora | None = None):
        self.model = model.requires_grad_(False)
        self.lora_cfg = lora_cfg
        if lora is None:
            lora = init_lora(model, lora_cfg, generator)
        dev = next(model.buffers(), next(model.parameters(), None)).device
        self.lora = {p: {n: t.detach().to(dev, torch.float32).requires_grad_()
                         for n, t in ab.items()} for p, ab in lora.items()}
        self.opt = torch.optim.AdamW(
            [t for ab in self.lora.values() for t in ab.values()], lr=lr,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
        self.step = 0

    def train_step(self, input_embeds: torch.Tensor,
                   labels: torch.Tensor) -> float:
        loss = vlm_loss(self.model, self.lora, self.lora_cfg, input_embeds,
                        labels)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss.detach())

    def merged_state_dict(self) -> dict:
        return export_merged(self.model, self.lora, self.lora_cfg)


# ------------------------------------------------------- adapter archives
def save_lora_npz(lora: Lora, cfg: LoraConfig, path) -> None:
    """One npz of the adapters under the JAX package's flattened keys
    (`layer_i/q_proj/a`) plus the LoraConfig as the `__meta__` json."""
    flat = {f"{layer}/{proj}/{n}": arr
            for layer, projs in lora_to_jax(lora).items()
            for proj, ab in projs.items() for n, arr in ab.items()}
    np.savez(path, __meta__=json.dumps(
        {"r": cfg.r, "alpha": cfg.alpha, "targets": list(cfg.targets)}),
        **flat)


def load_lora_npz(path, device=None) -> tuple[Lora, LoraConfig]:
    """Inverse of save_lora_npz; reads the JAX package's archives too."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    tree: dict = {}
    for key in z.files:
        if key == "__meta__":
            continue
        layer, proj, n = key.split("/")
        tree.setdefault(layer, {}).setdefault(proj, {})[n] = z[key]
    return lora_from_jax(tree, device), LoraConfig(
        r=meta["r"], alpha=meta["alpha"], targets=tuple(meta["targets"]))


def load_projector_npz(path) -> Dict[str, torch.Tensor]:
    """The mm projector's state dict ("0.weight", ..., fp32) from a JAX
    projector archive (save_projector_npz: the Flax tree flattened to
    `params/fc0/kernel`, ...)."""
    z = np.load(path, allow_pickle=False)
    tree: dict = {}
    for key in z.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return params_from_jax("projector", tree, None)
