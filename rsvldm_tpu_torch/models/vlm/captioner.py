"""LLaVA captioner (rsvldm_tpu/models/vlm/captioner.py): builds the
decoder, vision tower, projector and image_newline from one HF-named LLaVA
state dict, or reads them from a checkpoint directory, and captions one
image.

State-dict names are the reference checkpoint's: the language model under
`model.embed_tokens`, `model.layers.*`, `model.norm`, `lm_head`; the tower
under `model.vision_tower.vision_tower.vision_model.*`; the projector under
`model.mm_projector.{0,2}`; `model.image_newline`. The tokenizer is any
object with encode(text, add_special_tokens=False) and
decode(ids, skip_special_tokens=True); `load` reads the Llama-3 one from
<ckpt_dir>/llava/tokenizer.json (tokenizer.py).

`load` reads <ckpt_dir>/llava (sorted *.safetensors shards, else
pytorch_model*.bin), merges the PEFT adapter of <ckpt_dir>/Llava-next into
the base weights in fp32 on the host (W + (lora_alpha / r) * B @ A, the
numpy expression of rsvldm_tpu/utils/convert_hf.py::merge_lora), fills the
modules on the device in the compute dtype tensor by tensor, then
quantizes. Train_vlm archives attach after that: a LoRA archive folds into
an fp decoder and rides the runtime branch of an int8 / int4 one (every
prefill and decode step gets `lora`); a projector archive replaces the
checkpoint's projector.

`caption_batch` captions several images in one batched decode
(generate.caption_images), through the same runtime LoRA branch, kept
decode graphs and stats as `caption`.

Speculative decoding (JAX captioner.py:226-322, speculative.py): `load`
reads a Llama-family draft from `draft_dir`, by default
<ckpt_dir>/llava_draft when it exists (`draft_dir=False` disables that),
with its geometry from its config.json (a tied lm_head too), quantized
as the target; a draft
of another hidden size or vocabulary raises, as does a named draft
directory that is missing or holds no weights. Without a draft,
`self_draft_layers` N > 0 makes one of the target's first N blocks. Then
`caption` decodes with speculative rounds of `spec_k` proposals; the ids
are the target's (greedy exactly, sampled in distribution), the speed is
the draft's. `caption_batch` stays on the batched vanilla decode, as in
JAX.

Tensor parallelism (`mesh=` on `from_state_dict`, `seeded` and `load`;
JAX captioner.py:103-220): the decoder is sharded over the mesh's 'data'
group (parallel/llama_sharding.py), each rank building only its shard
part by part (`build_sharded_llama`: one full block at a time, quantized,
then cut), the tower and projector whole on every rank. Every rank runs
the same caption; the ranks' ids are checked equal. As in JAX, a draft
(checkpoint or self-draft) is not composed with TP: it is skipped with a
warning. LoRA archives are refused on a sharded decoder.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import re
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ...device import compute_dtype, resolve_device
from ...training.vlm_trainer import (apply_lora, load_lora_npz,
                                     load_projector_npz, quant_mode,
                                     runtime_lora)
from ...utils.checkpoint import load_checked, load_torch_state_dict
from ...utils.weights import init_params_, seeded_generator, seeded_init_
from .generate import (GenerateConfig, caption_image, caption_images,
                       embed_multimodal_prompt)
from .llama import LLAMA3_8B_CONFIG, LlamaConfig, LlamaModel, quantize_llama_
from .projector import MLPProjector
from .speculative import self_draft, speculative_generate
from .tokenizer import Llama3Tokenizer
from .vision import CLIP_VIT_L_336_CONFIG, CLIPVisionConfig, CLIPVisionTower

log = logging.getLogger("rsvldm_torch")

VISION_PREFIX = "model.vision_tower.vision_tower."
PROJECTOR_PREFIX = "model.mm_projector."
NEWLINE_KEY = "model.image_newline"


def split_llava_state_dict(sd: Dict[str, torch.Tensor]):
    """One LLaVA state dict -> (llama, vision, projector, image_newline),
    each with its module's own names."""
    llama, vision, projector = {}, {}, {}
    for k, v in sd.items():
        if k.startswith(VISION_PREFIX):
            vision[k[len(VISION_PREFIX):]] = v
        elif k.startswith(PROJECTOR_PREFIX):
            projector[k[len(PROJECTOR_PREFIX):]] = v
        elif k != NEWLINE_KEY:
            llama[k] = v
    return llama, vision, projector, sd[NEWLINE_KEY]


def _empty_parts(llama_cfg, vision_cfg, device, dtype, llama: bool = True):
    """(decoder, tower, projector) on `device` in `dtype`, uninitialised,
    built without allocating twice (meta first); without the decoder
    unless `llama`."""
    parts = []
    for module_cls, args in ((LlamaModel, (llama_cfg,)),
                             (CLIPVisionTower, (vision_cfg,)),
                             (MLPProjector, (vision_cfg.width, llama_cfg.dim))):
        if module_cls is LlamaModel and not llama:
            continue
        with torch.device("meta"):
            module = module_cls(*args)
        parts.append(module.to(dtype=dtype).to_empty(device=device))
    return parts


def load_sharded(d: Path) -> tuple[dict, List[str]]:
    """(the merged state dict of d's sorted *.safetensors shards, else of its
    pytorch_model*.bin shards; the files), tensors mapped from the files
    (JAX `_load_sharded`)."""
    files = sorted(glob.glob(str(d / "*.safetensors"))) or \
        sorted(glob.glob(str(d / "pytorch_model*.bin")))
    sd: dict = {}
    for f in files:
        sd.update(load_torch_state_dict(f))
    return sd, files


_LORA_A = re.compile(r"base_model\.model\.(.+)\.lora_A(?:\.default)?\.weight")


def merge_peft(sd: dict, adapter_dir: Path) -> tuple[dict, int]:
    """(sd with a PEFT adapter folded into its base weights, the count of
    merged weights), JAX `_apply_lora`: scale lora_alpha / r from
    adapter_config.json (1.0 without it), W + scale * B @ A computed in fp32
    numpy as rsvldm_tpu/utils/convert_hf.py::merge_lora does. The merged
    weights are fp32 host tensors; the other entries stay mapped."""
    scale = 1.0
    cfg_path = adapter_dir / "adapter_config.json"
    if cfg_path.exists():
        with open(cfg_path) as f:
            acfg = json.load(f)
        scale = acfg.get("lora_alpha", 16) / max(acfg.get("r", 16), 1)
    asd, _ = load_sharded(adapter_dir)
    if not asd:
        for p in glob.glob(str(adapter_dir / "adapter_model*")):
            asd.update(load_torch_state_dict(p))
    f32 = lambda t: t.detach().float().numpy()
    merged, n = dict(sd), 0
    for k in asd:
        m = _LORA_A.fullmatch(k)
        if not m:
            continue
        base_key, b_key = m.group(1) + ".weight", k.replace("lora_A", "lora_B")
        if base_key in merged and b_key in asd:
            merged[base_key] = torch.from_numpy(
                f32(merged[base_key]) + scale * (f32(asd[b_key]) @ f32(asd[k])))
            n += 1
    log.info("merged %d LoRA deltas (scale %.3f)", n, scale)
    return merged, n


def _llama_config_from_json(d: Path, base: LlamaConfig) -> LlamaConfig:
    """The LlamaConfig of an HF config.json in d (a draft checkpoint's own
    geometry), keys it lacks taken from `base` (JAX
    `_llama_config_from_json`)."""
    p = d / "config.json"
    if not p.exists():
        return base
    with open(p) as f:
        raw = json.load(f)
    return dataclasses.replace(
        base,
        vocab_size=raw.get("vocab_size", base.vocab_size),
        dim=raw.get("hidden_size", base.dim),
        layers=raw.get("num_hidden_layers", base.layers),
        heads=raw.get("num_attention_heads", base.heads),
        kv_heads=raw.get("num_key_value_heads", base.kv_heads),
        ffn_dim=raw.get("intermediate_size", base.ffn_dim),
        rope_theta=raw.get("rope_theta", base.rope_theta),
        rms_eps=raw.get("rms_norm_eps", base.rms_eps),
        tie_lm_head=raw.get("tie_word_embeddings", base.tie_lm_head))


def _sharded_llama(cfg, fill, mesh, device, dtype, quant):
    """This rank's shard of the decoder over the mesh's 'data' group (the
    axis JAX shards the decoder over)."""
    from ...parallel.llama_sharding import build_sharded_llama
    return build_sharded_llama(cfg, fill, mesh.get_group("data"), device,
                               dtype, quant=quant or None)


def _placement(device, dtype):
    """(device, dtype): the card unless the caller names a device (raising
    when CUDA is asked for without a card), its compute dtype unless
    given."""
    device = resolve_device(device)
    return device, dtype or compute_dtype(device)


def _now(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class LlavaCaptioner:
    def __init__(self, llama: LlamaModel, vision: CLIPVisionTower,
                 projector: MLPProjector, image_newline: torch.Tensor,
                 tokenizer):
        self.llama = llama
        self.vision = vision
        self.projector = projector
        self.image_newline = image_newline
        self.tokenizer = tokenizer
        # adapters of a quantized decoder's runtime branch (scale in b),
        # from attach_archives
        self.lora: dict | None = None
        # the decode loop's tensors and CUDA graph per (prompt bucket,
        # lora): a later caption of the same bucket replays, as JAX's
        # jit cache does (generate.generate)
        self.decode_graphs: dict = {}
        # speculative decoding: the draft model, the proposals a round, and
        # the self-draft's depth (0 for a draft checkpoint)
        self.draft: LlamaModel | None = None
        self.spec_k = 4
        self.self_draft_layers = 0
        self.last_stats: dict = {}
        # seconds of each load step (read_s, merge_s, quantize_s,
        # archives_s) and the files read
        self.load_stats: dict = {}

    @classmethod
    @torch.no_grad()
    def from_state_dict(cls, sd: Dict[str, torch.Tensor],
                        llama_cfg: LlamaConfig = LLAMA3_8B_CONFIG,
                        vision_cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG,
                        tokenizer=None, quant: str | None = None,
                        device: str | torch.device | None = None,
                        dtype: torch.dtype | None = None,
                        mesh=None) -> "LlavaCaptioner":
        """Modules built on `device` in `dtype` and filled from `sd` tensor by
        tensor (missing names raise, extras are logged); with quant 'int8' /
        'int4' the decoder is then quantized module by module (its
        embedding table narrowed to bf16, as the JAX loader does). The
        device defaults to the card (device.resolve_device: raises without
        one), the dtype to its compute dtype (bf16 on the card, fp32 on the
        CPU). mesh: the decoder sharded over its 'data' group, built part
        by part (module docstring)."""
        device, dtype = _placement(device, dtype)
        t0 = _now(device)
        llama_sd, vision_sd, projector_sd, newline = split_llava_state_dict(sd)
        if mesh is None:
            parts = _empty_parts(llama_cfg, vision_cfg, device, dtype)
            load_checked(parts[0], llama_sd, "llama")
        else:
            def fill(name, part):
                pre = name + "."
                load_checked(part, {k[len(pre):]: v for k, v in llama_sd.items()
                                    if k.startswith(pre)}, f"llama {name}")
            parts = [_sharded_llama(llama_cfg, fill, mesh, device, dtype, quant),
                     *_empty_parts(llama_cfg, vision_cfg, device, dtype,
                                   llama=False)]
        for module, part_sd, what in zip(parts[1:], (vision_sd, projector_sd),
                                         ("vision tower", "projector")):
            load_checked(module, part_sd, what)
        newline = newline.to(device=device, dtype=dtype)
        read_s = _now(device) - t0
        cap = cls._finish(parts, newline, tokenizer, quant)
        cap.load_stats["read_s"] = read_s
        return cap

    @classmethod
    @torch.no_grad()
    def seeded(cls, llama_cfg: LlamaConfig = LLAMA3_8B_CONFIG,
               vision_cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG,
               tokenizer=None, quant: str | None = None,
               device: str | torch.device | None = None,
               dtype: torch.dtype | None = None,
               mesh=None) -> "LlavaCaptioner":
        """Seeded random weights (utils/weights.seeded_init_, on the device)
        instead of a checkpoint: smoke mode, the captions mean nothing.
        Device and dtype default as in `from_state_dict`; with `mesh`, each
        rank draws the decoder part by part with seeded_init_'s generator
        (the same numbers) and keeps its shard."""
        device, dtype = _placement(device, dtype)
        if mesh is None:
            parts = _empty_parts(llama_cfg, vision_cfg, device, dtype)
        else:
            gen = seeded_generator("llama", torch.device(device))
            parts = [_sharded_llama(llama_cfg,
                                    lambda name, part: init_params_(part, gen),
                                    mesh, device, dtype, quant),
                     *_empty_parts(llama_cfg, vision_cfg, device, dtype,
                                   llama=False)]
        for module, family in zip(parts, ("llama", "clip_vision", "projector")):
            if mesh is None or family != "llama":
                seeded_init_(module, family, torch.device(device))
        gen = torch.Generator(device=device).manual_seed(
            zlib.crc32(b"image_newline"))
        newline = torch.randn(llama_cfg.dim, generator=gen, device=device,
                              dtype=torch.float32).mul_(0.02).to(dtype)
        return cls._finish(parts, newline, tokenizer, quant)

    @classmethod
    def _finish(cls, parts, newline, tokenizer, quant):
        if tokenizer is None:
            raise ValueError("LlavaCaptioner: a tokenizer is required "
                             "(LlavaCaptioner.load reads tokenizer.json)")
        llama, vision, projector = (m.eval().requires_grad_(False) for m in parts)
        t0 = _now(newline.device)
        # build_sharded_llama quantizes part by part (any mesh)
        if quant and quant_mode(llama) is None:
            quantize_llama_(llama, quant)
        cap = cls(llama, vision, projector, newline, tokenizer)
        cap.load_stats["quantize_s"] = _now(newline.device) - t0
        return cap

    @torch.no_grad()
    def attach_archives(self, lora_npz: str | Path | None = None,
                        projector_npz: str | Path | None = None):
        """train_vlm's archives (JAX captioner.py:185-209): a LoRA archive
        (save_lora_npz, either package's) folds into an fp decoder's
        weights, or becomes the runtime branch of an int8 / int4 one; a
        projector archive replaces the projector's weights wholesale."""
        dev = self.image_newline.device
        t0 = _now(dev)
        if lora_npz and self.llama.tp is not None:
            raise NotImplementedError("LoRA archives on a tensor-parallel "
                                      "decoder are not ported")
        if lora_npz:
            lora, lcfg = load_lora_npz(lora_npz, dev)
            quantized = quant_mode(self.llama) is not None
            self.decode_graphs.clear()
            if quantized:
                self.lora = runtime_lora(lora, lcfg.scale)
            else:
                self.llama.load_state_dict(apply_lora(self.llama, lora, lcfg.scale))
            log.info("LoRA adapters attached from %s (r=%d, %s)", lora_npz,
                     lcfg.r, "runtime branch" if quantized else "folded")
        if projector_npz:
            load_checked(self.projector, load_projector_npz(projector_npz),
                         f"projector archive {projector_npz}")
            log.info("projector weights replaced from %s", projector_npz)
        if lora_npz or projector_npz:
            self.load_stats["archives_s"] = _now(dev) - t0

    @classmethod
    def load(cls, ckpt_dir: str | Path,
             llama_cfg: LlamaConfig = LLAMA3_8B_CONFIG,
             vision_cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG,
             tokenizer=None, quant: str | None = None,
             device: str | torch.device | None = None,
             dtype: torch.dtype | None = None,
             lora_npz: str | Path | None = None,
             projector_npz: str | Path | None = None,
             draft_dir: str | Path | None | bool = None,
             spec_k: int = 4, self_draft_layers: int = 0, mesh=None
             ) -> Optional["LlavaCaptioner"]:
        """The captioner of <ckpt_dir>/llava (JAX LlavaCaptioner.load,
        captioner.py:122-278): the shards, the Llava-next PEFT adapter
        merged in fp32, the modules on `device` in `dtype`, `quant`, the
        archives, the tokenizer (tokenizer.json unless one is given), and
        the speculative draft (`attach_draft`). None when <ckpt_dir>/llava
        is missing or holds no weights. Device and dtype default as in
        `from_state_dict`; `mesh` shards the decoder (module docstring)."""
        device, dtype = _placement(device, dtype)
        d = Path(ckpt_dir) / "llava"
        if not d.is_dir():
            return None
        t0 = time.perf_counter()
        sd, files = load_sharded(d)
        if not sd:
            return None
        open_s = time.perf_counter() - t0
        if tokenizer is None:
            tokenizer = Llama3Tokenizer.from_dir(d)
        merge_s, merged = 0.0, 0
        adapter = Path(ckpt_dir) / "Llava-next"
        if adapter.is_dir():
            t0 = time.perf_counter()
            sd, merged = merge_peft(sd, adapter)
            merge_s = time.perf_counter() - t0
            files = files + [str(adapter)]
        cap = cls.from_state_dict(sd, llama_cfg, vision_cfg, tokenizer, quant,
                                  device, dtype, mesh)
        cap.attach_archives(lora_npz, projector_npz)
        cap.load_stats.update(files=files, open_s=open_s, merge_s=merge_s,
                              peft_merged=merged)
        dd = (None if draft_dir is False
              else Path(draft_dir) if draft_dir else Path(ckpt_dir) / "llava_draft")
        cap.attach_draft(dd, named=bool(draft_dir), spec_k=spec_k,
                         self_draft_layers=self_draft_layers, quant=quant,
                         mesh=mesh)
        return cap

    @torch.no_grad()
    def attach_draft(self, draft_dir: Path | None, named: bool = True,
                     spec_k: int = 4, self_draft_layers: int = 0,
                     quant: str | None = None, mesh=None):
        """The speculative draft (JAX captioner.py:226-278): the Llama
        checkpoint of `draft_dir` (sorted *.safetensors shards, else
        pytorch_model*.bin; config.json over the target's geometry) on the
        target's device and dtype, quantized with `quant`; else, with
        `self_draft_layers` N > 0, the target's first N blocks. A `named`
        directory that is missing or holds no weights raises
        FileNotFoundError; another hidden size or vocabulary, ValueError.
        Under a mesh (even of one rank, as in JAX) no draft is attached."""
        self.spec_k = spec_k
        self.decode_graphs.clear()
        draft = None
        if mesh is not None or self.llama.tp is not None:
            # JAX captioner.py:233-237, 268-270: the draft's caches are not
            # sharded, so captions under a mesh decode vanilla
            if (draft_dir is not None and draft_dir.is_dir()) or self_draft_layers:
                log.warning("speculative draft skipped: the draft and mesh TP "
                            "are not composed")
            self.draft, self.self_draft_layers = None, 0
            return
        if draft_dir is not None and draft_dir.is_dir():
            t0 = time.perf_counter()
            sd, files = load_sharded(draft_dir)
            if not sd and named:
                raise FileNotFoundError(
                    f"--draft_dir {draft_dir} contains no safetensors weights")
            if sd:
                draft = self._load_draft(draft_dir, sd, quant)
                self.load_stats.update(draft_files=files,
                                       draft_s=_now(self.image_newline.device) - t0)
                log.info("speculative draft loaded from %s (%d layers, k=%d)",
                         draft_dir, draft.cfg.layers, spec_k)
        elif draft_dir is not None and named:
            raise FileNotFoundError(f"--draft_dir {draft_dir} does not exist")
        self.self_draft_layers = 0
        if draft is None and self_draft_layers:
            draft = self_draft(self.llama, self_draft_layers)
            self.self_draft_layers = self_draft_layers
            log.info("self-draft: first %d of %d target layers",
                     self_draft_layers, self.llama.cfg.layers)
        self.draft = draft

    def _load_draft(self, draft_dir: Path, sd: dict, quant) -> LlamaModel:
        tcfg = self.llama.cfg
        dcfg = _llama_config_from_json(draft_dir, tcfg)
        if dcfg.dim != tcfg.dim:
            raise ValueError(
                f"draft hidden dim {dcfg.dim} != target {tcfg.dim} — "
                "speculative decoding feeds the spliced prompt embeds to "
                "both models")
        if dcfg.vocab_size != tcfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target {tcfg.vocab_size} "
                "— the acceptance rule compares the two token distributions "
                "elementwise (the models must share a tokenizer)")
        dev = self.image_newline.device
        with torch.device("meta"):
            draft = LlamaModel(dcfg)
        draft = draft.to(dtype=self.image_newline.dtype).to_empty(device=dev)
        load_checked(draft, sd, f"draft ({draft_dir})")
        draft.eval().requires_grad_(False)
        if quant:
            quantize_llama_(draft, quant)
        return draft

    def _gen_setup(self, llava_cfg):
        """The prompt, GenerateConfig and tokenizer closures of `caption`
        and `caption_batch` (one definition, as JAX's `_gen_setup`)."""
        prompt = llava_cfg.img_prompt.format(DEFAULT_IMAGE_TOKEN="<image>")
        cfg = GenerateConfig(max_new_tokens=llava_cfg.max_new_tokens,
                             temperature=llava_cfg.temperature,
                             do_sample=llava_cfg.do_sample)
        encode = lambda s: self.tokenizer.encode(s, add_special_tokens=False)
        decode = lambda ids: self.tokenizer.decode(ids, skip_special_tokens=True)
        return prompt, cfg, encode, decode

    @torch.inference_mode()
    def caption(self, image, llava_cfg,
                generator: torch.Generator | None = None,
                noise=None, accept_noise=None) -> str:
        """Stage 2a on one PIL image; sampling adds `noise(i)` to token i's
        logits, or Gumbel draws from `generator` (default: seeded with 0 on
        the captioner's device); on the card the decode replays a CUDA
        graph kept in `decode_graphs`; see `generate.generate`. With a
        draft, speculative rounds decode (`_generate_fn`), `accept_noise`
        giving their acceptance and resample draws."""
        prompt, cfg, encode, decode = self._gen_setup(llava_cfg)
        self.last_stats = {}
        return caption_image(self.llama, self.vision, self.projector, image,
                             prompt, encode, decode, self.image_newline, cfg,
                             generator, patch_size=self.vision.cfg.image_size,
                             stats=self.last_stats, noise=noise, lora=self.lora,
                             graph_cache=self.decode_graphs,
                             generate_fn=self._generate_fn(accept_noise))

    def _generate_fn(self, accept_noise=None):
        """The decode of `caption` (JAX `_generate_fn`): speculative rounds
        when a draft is attached, else None (generate.generate)."""
        if self.draft is None:
            return None
        # a self-draft's blocks are the target's first ones, so the
        # target's adapters (looked up by block index) serve it as they are
        draft_lora = self.lora if self.self_draft_layers else None
        return lambda model, spliced, cfg, generator, **kw: speculative_generate(
            model, self.draft, spliced, cfg, self.spec_k, generator,
            accept_noise=accept_noise, draft_lora=draft_lora, **kw)

    @torch.inference_mode()
    def embed_mm(self, prompt: str, images) -> torch.Tensor:
        """The serving engine's multimodal prompt embedder (JAX
        captioner.py:347-359; LLMWorker(embed_mm=cap.embed_mm)): the
        rendered prompt with one anyres feature stream per <image>, spliced
        in order -> [S, D] on the captioner's device; no images gives the
        text's embeddings."""
        encode = lambda s: self.tokenizer.encode(s, add_special_tokens=False)
        return embed_multimodal_prompt(
            self.llama, self.vision, self.projector, prompt, list(images),
            encode, self.image_newline, patch_size=self.vision.cfg.image_size)

    @torch.inference_mode()
    def caption_batch(self, images, llava_cfg,
                      generator: torch.Generator | None = None,
                      noise=None) -> list:
        """Stage 2a on several PIL images in one batched decode (JAX
        captioner.py:361-372): one caption per image, in order. `noise(i)`
        gives [B, vocab]; otherwise as `caption`. `last_stats` has the
        prompt lengths, the padded length, prefill and decode seconds and
        the steps run."""
        prompt, cfg, encode, decode = self._gen_setup(llava_cfg)
        self.last_stats = {}
        return caption_images(self.llama, self.vision, self.projector,
                              list(images), prompt, encode, decode,
                              self.image_newline, cfg, generator,
                              patch_size=self.vision.cfg.image_size,
                              stats=self.last_stats, noise=noise,
                              lora=self.lora, graph_cache=self.decode_graphs)

    def video_features(self, frames, stride: int = 2,
                       pool_mode: str = "bilinear",
                       newline_position: str = "grid") -> torch.Tensor:
        """PIL frames -> the flat video stream [T', D] spliced at <image>
        (JAX captioner.py:324-345): CLIP's short-side resize and centre
        crop per frame, every frame through the tower and projector in one
        batched call, then video.video_feature_stream (the reference's
        training defaults: bilinear pooling, a newline per grid row)."""
        import numpy as np

        from .video import clip_preprocess_frame, video_feature_stream
        from .vision import normalize_pixels
        s = self.vision.cfg.image_size
        px = torch.from_numpy(np.stack([clip_preprocess_frame(f, s)
                                        for f in frames]))
        dev, dt = self.image_newline.device, self.image_newline.dtype
        tower = self.vision(normalize_pixels(px.to(dev, dt)))
        w = next(self.projector.parameters())
        feats = self.projector(tower.to(w.dtype))
        return video_feature_stream(feats, self.image_newline, stride=stride,
                                    pool_mode=pool_mode,
                                    newline_position=newline_position)
