"""LLaVA finetuning with LoRA adapters on a frozen base
(rsvldm_tpu/training/vlm_trainer.py, the QLoRA recipe when the base is int8
or int4): supervised (VLMTrainer), with the projector inside the
differentiated graph (MMTrainer: the pretrain stage and the joint
finetune) and preference optimization (DPOTrainer).

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

A trained projector is fp32 (MMTrainer widens it in place); the frozen
base's reference policy in DPO is the same model run without adapters.

Data parallelism (`mesh=` on the three trainers, JAX vlm_trainer.py:289-
452), as SR3Trainer's: the adapters (and MMTrainer's trained projector)
are broadcast from the mesh's first rank; `train_step` takes this rank's
rows of the global batch, as JAX's multi-process put_batch does; one
all-reduce sums every trainable gradient before AdamW, so the ranks stay
equal. Each rank's loss is its share of the global batch's: the masked CE
divides the rank's NLL sum by the supervised-token count of the global
batch (all-reduced; JAX's masked_ce divides by that count, and a mean of
the ranks' means would weigh their tokens unevenly), DPO's mean over the
rank's pairs by its share of the global pair count (all-reduced, so the
ranks may hold unequal numbers of pairs). The loss returned is the global
batch's.
A mesh of one gives the bits of no mesh.

Archives (`save_lora_npz` / `load_lora_npz`) keep the JAX package's keys
(`layer_i/q_proj/a`, `__meta__`), so either package reads the other's;
`save_projector_npz` / `load_projector_npz` the JAX projector archives'
(`params/fc0/kernel`, ...).
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.vlm.llama import Q4Dense, QDense
from ..ops.quant import QuantizedLinear, dequantize_int8, quantize_weight
from ..utils import prng
from ..utils.weights import (jax_lora_path, lora_from_jax, lora_to_jax,
                             params_from_jax)

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
              key: prng.Key | None = None) -> Lora:
    """A ~ U[-1/sqrt(in), 1/sqrt(in)) (PEFT's lora_A init), B = 0, for
    every target projection, on the projection's device: JAX's draws,
    uniform(fold_in(key, crc32(path) % 2^31), (in, r), -bound, bound) with
    `path` JAX's adapter path ("layer_i/proj", jax_lora_path) and key
    default PRNGKey(0), so the same key gives JAX's adapters."""
    key = prng.key(0) if key is None else key
    lora: Lora = {}
    for path, mod in _targets(model, cfg):
        in_f, out_f = _dims(mod)
        dev = next(mod.buffers(), next(mod.parameters(), None)).device
        bound = 1.0 / float(in_f) ** 0.5
        word = zlib.crc32(jax_lora_path(path).encode()) % 2 ** 31
        k = prng.fold_in(key, word)
        lora[path] = {"a": prng.uniform(k, (in_f, cfg.r), minval=-bound,
                                        maxval=bound, device=dev),
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


def supervised_count(labels: torch.Tensor) -> torch.Tensor:
    """The number of supervised next-token targets (a 0-d long tensor)."""
    return (labels[:, 1:] != IGNORE_INDEX).sum()


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              count: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy summed over the supervised targets
    (labels != IGNORE_INDEX) and divided by `count` (default: their
    number; a data-parallel rank passes the global batch's); 0 when none
    is."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    n = (supervised_count(labels) if count is None else count).clamp_min(1)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="sum")
    return nll / n


def _lora_leaves(lora: Lora | None) -> list:
    return [] if lora is None else [t for ab in lora.values() for t in ab.values()]


def _adamw(groups) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=0) per parameter group."""
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.0)


def _descend(opt: torch.optim.Optimizer, loss: torch.Tensor,
             group=None) -> float:
    """One optimizer step on `loss`; returns its value. With a data-parallel
    `group`, `loss` is this rank's share of the global loss: the gradients
    of every trainable tensor are summed over the group (one all-reduce)
    before the step, and so is the loss returned."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if group is None:
        opt.step()
        return float(loss.detach())
    from ..parallel.distributed import all_reduce, all_reduce_grads
    all_reduce_grads([p for g in opt.param_groups for p in g["params"]
                      if p.grad is not None], group)
    opt.step()
    return float(all_reduce(loss.detach().clone(), group))


class _DataParallel:
    """The trainers' mesh (JAX `mesh=`): None, or the mesh whose first rank
    the trainable state is broadcast from and whose group sums the
    gradients."""

    def _set_mesh(self, mesh, trainable: list):
        self.mesh = mesh
        self.group = None
        if mesh is not None:
            from ..parallel.mesh import mesh_group, replicate_state
            with torch.no_grad():
                replicate_state(mesh, [t.detach() for t in trainable])
            self.group = mesh_group(mesh)

    def _count(self, labels: torch.Tensor) -> torch.Tensor | None:
        """The global batch's supervised-target count over the mesh."""
        if self.group is None:
            return None
        from ..parallel.distributed import all_reduce
        return all_reduce(supervised_count(labels), self.group)


def _trainable_lora(model: nn.Module, lora_cfg: LoraConfig,
                    key: prng.Key | None,
                    lora: Lora | None) -> Lora:
    """Adapters as fp32 leaves that require grad on the model's device:
    `lora` when given (a test feeds JAX's), else init_lora's draw."""
    if lora is None:
        lora = init_lora(model, lora_cfg, key)
    dev = next(model.buffers(), next(model.parameters(), None)).device
    return {p: {n: t.detach().to(dev, torch.float32).requires_grad_()
                for n, t in ab.items()} for p, ab in lora.items()}


def vlm_loss(model: nn.Module, lora: Lora | None, lora_cfg: LoraConfig,
             input_embeds: torch.Tensor, labels: torch.Tensor,
             count: torch.Tensor | None = None) -> torch.Tensor:
    """Masked next-token loss; input_embeds [B, S, D] already hold the
    spliced image features, labels [B, S] IGNORE_INDEX where unsupervised.
    A prefill from 0 with no KV cache. count: masked_ce's divisor."""
    logits, _ = apply_model(model, lora, lora_cfg, input_embeds)
    return masked_ce(logits, labels, count)


def splice_span(text_embeds: torch.Tensor, feats: torch.Tensor,
                img_pos) -> torch.Tensor:
    """Row b of text_embeds [B, S, D] with feats[b] [T, D] written over
    rows img_pos[b] .. img_pos[b] + T - 1, out of place so the gradient
    reaches feats; the start is clamped into [0, S - T], as JAX's
    dynamic_update_slice clamps it."""
    s, t = text_embeds.shape[1], feats.shape[1]
    rows = []
    for e, f, p in zip(text_embeds, feats, [int(p) for p in img_pos]):
        p = max(0, min(p, s - t))
        rows.append(torch.cat([e[:p], f.to(e.dtype), e[p + t:]], dim=0))
    return torch.stack(rows)


def mm_loss(model: nn.Module, lora: Lora | None, lora_cfg: LoraConfig,
            projector: nn.Module, vis_feats: torch.Tensor,
            text_embeds: torch.Tensor, img_pos, labels: torch.Tensor,
            count: torch.Tensor | None = None) -> torch.Tensor:
    """Masked next-token loss with the projector inside the differentiated
    graph. vis_feats [B, T, Dv] are tower features before the projector;
    text_embeds [B, S, D] hold a zero-filled span of T rows at img_pos[b]
    (labels IGNORE there), which the projected features fill, so the
    projector's gradient flows back through every block. count:
    masked_ce's divisor."""
    w = next(projector.parameters())
    feats = projector(vis_feats.to(w.device, w.dtype))
    emb = splice_span(text_embeds, feats, img_pos)
    logits, _ = apply_model(model, lora, lora_cfg, emb)
    return masked_ce(logits, labels, count)


def sequence_logprob(model: nn.Module, embeds: torch.Tensor,
                     labels: torch.Tensor, lora: Lora | None = None,
                     lora_cfg: LoraConfig | None = None) -> torch.Tensor:
    """[B]: the summed log-probabilities of each row's supervised next
    tokens."""
    logits, _ = apply_model(model, lora, lora_cfg, embeds)
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1), ignore_index=IGNORE_INDEX,
                          reduction="none")
    return -nll.reshape(targets.shape).sum(-1)


def dpo_loss(model: nn.Module, lora: Lora, lora_cfg: LoraConfig,
             chosen_embeds, chosen_labels, rejected_embeds, rejected_labels,
             beta: float = 0.1) -> torch.Tensor:
    """Direct preference optimization: -log sigmoid(beta * ((pi_c - ref_c)
    - (pi_r - ref_r))) averaged over the pairs. The reference policy is the
    frozen base without adapters; its two forwards run without a graph (no
    gradient reaches them in JAX either)."""
    pi_c = sequence_logprob(model, chosen_embeds, chosen_labels, lora,
                            lora_cfg)
    pi_r = sequence_logprob(model, rejected_embeds, rejected_labels, lora,
                            lora_cfg)
    with torch.no_grad():
        ref_c = sequence_logprob(model, chosen_embeds, chosen_labels)
        ref_r = sequence_logprob(model, rejected_embeds, rejected_labels)
    margin = beta * ((pi_c - ref_c) - (pi_r - ref_r))
    return -F.logsigmoid(margin).mean()


class VLMTrainer(_DataParallel):
    """LoRA finetuning of the decoder: AdamW (optax's adamw with weight
    decay 0) over the adapters only; the base is frozen in place. mesh:
    data parallelism (module docstring)."""

    def __init__(self, model: nn.Module, lora_cfg: LoraConfig = LoraConfig(),
                 lr: float = 2e-4, key: prng.Key | None = None,
                 lora: Lora | None = None, mesh=None):
        self.model = model.requires_grad_(False)
        self.lora_cfg = lora_cfg
        self.lora = _trainable_lora(model, lora_cfg, key, lora)
        self._set_mesh(mesh, _lora_leaves(self.lora))
        self.opt = _adamw([{"params": _lora_leaves(self.lora), "lr": lr}])
        self.step = 0

    def train_step(self, input_embeds: torch.Tensor,
                   labels: torch.Tensor) -> float:
        """input_embeds [B, S, D], labels [B, S]: the batch, or with a mesh
        this rank's rows of the global batch."""
        self.step += 1
        return _descend(self.opt, vlm_loss(
            self.model, self.lora, self.lora_cfg, input_embeds, labels,
            self._count(labels)), self.group)

    def merged_state_dict(self) -> dict:
        return export_merged(self.model, self.lora, self.lora_cfg)


class DPOTrainer(VLMTrainer):
    """LoRA-only DPO: the adapter-free base is the frozen reference policy,
    so one model serves both; fp, int8 and int4 bases."""

    def __init__(self, model: nn.Module, lora_cfg: LoraConfig = LoraConfig(),
                 lr: float = 5e-5, beta: float = 0.1,
                 key: prng.Key | None = None,
                 lora: Lora | None = None, mesh=None):
        super().__init__(model, lora_cfg, lr, key, lora, mesh)
        self.beta = beta

    def train_step(self, chosen_embeds, chosen_labels, rejected_embeds,
                   rejected_labels) -> float:
        """The pairs, or with a mesh this rank's pairs of the global batch
        (any number of them): the rank's mean over them is weighted by its
        share of the global batch's pairs, summed over the mesh."""
        self.step += 1
        loss = dpo_loss(self.model, self.lora, self.lora_cfg, chosen_embeds,
                        chosen_labels, rejected_embeds, rejected_labels,
                        self.beta)
        if self.group is not None:
            from ..parallel.distributed import all_reduce
            pairs = torch.tensor(float(chosen_labels.shape[0]),
                                 device=loss.device)
            loss = loss * (pairs / all_reduce(pairs.clone(), self.group))
        return _descend(self.opt, loss, self.group)


class MMTrainer(_DataParallel):
    """Trains any non-empty subset of {lora, projector} with the projector
    inside the graph: ("projector",) is the pretrain stage (decoder and
    tower frozen), ("lora", "projector") the joint finetune, the projector
    in its own AdamW group at `mm_projector_lr` (default `lr`), as
    optax.multi_transform. A trained projector is widened to fp32 in place
    and its parameters require grad; a frozen one is left as it is. mesh:
    data parallelism (module docstring)."""

    def __init__(self, model: nn.Module, projector: nn.Module,
                 lora_cfg: LoraConfig = LoraConfig(),
                 tune: Sequence[str] = ("lora", "projector"),
                 lr: float = 2e-4, mm_projector_lr: float | None = None,
                 key: prng.Key | None = None,
                 lora: Lora | None = None, mesh=None):
        if not tune or not set(tune) <= {"lora", "projector"}:
            raise ValueError(f"tune {tuple(tune)}: a non-empty subset of "
                             "{lora, projector}")
        self.model = model.requires_grad_(False)
        self.lora_cfg = lora_cfg
        self.tune = tuple(tune)
        self.projector = projector
        self.lora = (_trainable_lora(model, lora_cfg, key, lora)
                     if "lora" in tune else None)
        groups = []
        if self.lora is not None:
            groups.append({"params": _lora_leaves(self.lora), "lr": lr})
        if "projector" in tune:
            projector.float().requires_grad_(True)
            groups.append({"params": list(projector.parameters()),
                           "lr": lr if mm_projector_lr is None
                           else mm_projector_lr})
        else:
            projector.requires_grad_(False)
        self._set_mesh(mesh, [p for g in groups for p in g["params"]])
        self.opt = _adamw(groups)
        self.step = 0

    def train_step(self, vis_feats: torch.Tensor, text_embeds: torch.Tensor,
                   img_pos, labels: torch.Tensor) -> float:
        """vis_feats [B, T, Dv] tower features; text_embeds [B, S, D] with
        a zero span of T rows at img_pos[b]; labels [B, S]. With a mesh,
        this rank's rows of each."""
        self.step += 1
        return _descend(self.opt, mm_loss(
            self.model, self.lora, self.lora_cfg, self.projector, vis_feats,
            text_embeds, img_pos, labels, self._count(labels)), self.group)


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


def save_projector_npz(projector: nn.Module, path) -> None:
    """The projector under the JAX archive's keys (`params/fc0/kernel`
    [in, out], `params/fc0/bias`, ..., fp32), which the JAX package's
    load_projector_npz and load_projector_npz here read."""
    arr = lambda t: t.detach().float().cpu().numpy()
    flat = {}
    for i, lin in enumerate(m for m in projector if isinstance(m, nn.Linear)):
        flat[f"params/fc{i}/kernel"] = arr(lin.weight).T
        flat[f"params/fc{i}/bias"] = arr(lin.bias)
    np.savez(path, **flat)


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
