"""LLaVA captioner (rsvldm_tpu/models/vlm/captioner.py): builds the
decoder, vision tower, projector and image_newline from one HF-named LLaVA
state dict, and captions one image.

State-dict names are the reference checkpoint's: the language model under
`model.embed_tokens`, `model.layers.*`, `model.norm`, `lm_head`; the tower
under `model.vision_tower.vision_tower.vision_model.*`; the projector under
`model.mm_projector.{0,2}`; `model.image_newline`. The tokenizer is any
object with encode(text, add_special_tokens=False) and
decode(ids, skip_special_tokens=True).

Not ported yet: reading the checkpoint files and the Llama-3 BPE tokenizer,
the PEFT merge, LoRA and projector archives, speculative decoding, batched
captions.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Dict, Optional

import torch

from ...utils.weights import seeded_init_
from .generate import GenerateConfig, caption_image
from .llama import LLAMA3_8B_CONFIG, LlamaConfig, LlamaModel, quantize_llama_
from .projector import MLPProjector
from .vision import CLIP_VIT_L_336_CONFIG, CLIPVisionConfig, CLIPVisionTower

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


def _empty_parts(llama_cfg, vision_cfg, device, dtype):
    """(decoder, tower, projector) on `device` in `dtype`, uninitialised,
    built without allocating twice (meta first)."""
    parts = []
    for module_cls, args in ((LlamaModel, (llama_cfg,)),
                             (CLIPVisionTower, (vision_cfg,)),
                             (MLPProjector, (vision_cfg.width, llama_cfg.dim))):
        with torch.device("meta"):
            module = module_cls(*args)
        parts.append(module.to(dtype=dtype).to_empty(device=device))
    return parts


def _load(module: torch.nn.Module, sd: dict, what: str):
    """Loads what the module has; checkpoint extras (e.g. the tower's unused
    post_layernorm) are ignored, missing names raise."""
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{what}: state dict lacks {missing[:5]} "
                       f"({len(missing)} missing)")


class LlavaCaptioner:
    def __init__(self, llama: LlamaModel, vision: CLIPVisionTower,
                 projector: MLPProjector, image_newline: torch.Tensor,
                 tokenizer):
        self.llama = llama
        self.vision = vision
        self.projector = projector
        self.image_newline = image_newline
        self.tokenizer = tokenizer
        self.last_stats: dict = {}

    @classmethod
    @torch.no_grad()
    def from_state_dict(cls, sd: Dict[str, torch.Tensor],
                        llama_cfg: LlamaConfig = LLAMA3_8B_CONFIG,
                        vision_cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG,
                        tokenizer=None, quant: str | None = None,
                        device: str | torch.device = "cpu",
                        dtype: torch.dtype = torch.float32) -> "LlavaCaptioner":
        """Modules built on `device` in `dtype` and filled from `sd`; with
        quant 'int8' / 'int4' the decoder is then quantized module by module
        (its embedding table narrowed to bf16, as the JAX loader does)."""
        parts = _empty_parts(llama_cfg, vision_cfg, device, dtype)
        for module, part_sd, what in zip(parts, split_llava_state_dict(sd),
                                         ("llama", "vision tower", "projector")):
            _load(module, part_sd, what)
        newline = sd[NEWLINE_KEY].to(device=device, dtype=dtype)
        return cls._finish(parts, newline, tokenizer, quant)

    @classmethod
    @torch.no_grad()
    def seeded(cls, llama_cfg: LlamaConfig = LLAMA3_8B_CONFIG,
               vision_cfg: CLIPVisionConfig = CLIP_VIT_L_336_CONFIG,
               tokenizer=None, quant: str | None = None,
               device: str | torch.device = "cpu",
               dtype: torch.dtype = torch.float32) -> "LlavaCaptioner":
        """Seeded random weights (utils/weights.seeded_init_, on the device)
        instead of a checkpoint: smoke mode, the captions mean nothing."""
        parts = _empty_parts(llama_cfg, vision_cfg, device, dtype)
        for module, family in zip(parts, ("llama", "clip_vision", "projector")):
            seeded_init_(module, family, torch.device(device))
        gen = torch.Generator(device=device).manual_seed(
            zlib.crc32(b"image_newline"))
        newline = torch.randn(llama_cfg.dim, generator=gen, device=device,
                              dtype=torch.float32).mul_(0.02).to(dtype)
        return cls._finish(parts, newline, tokenizer, quant)

    @classmethod
    def _finish(cls, parts, newline, tokenizer, quant):
        if tokenizer is None:
            raise ValueError("LlavaCaptioner: a tokenizer is required (the "
                             "Llama-3 BPE tokenizer is not ported yet)")
        llama, vision, projector = (m.eval().requires_grad_(False) for m in parts)
        if quant:
            quantize_llama_(llama, quant)
        return cls(llama, vision, projector, newline, tokenizer)

    @classmethod
    def load(cls, ckpt_dir: str | Path, **kw) -> Optional["LlavaCaptioner"]:
        """None when <ckpt_dir>/llava is missing, as the JAX loader."""
        d = Path(ckpt_dir) / "llava"
        if not d.is_dir():
            return None
        raise NotImplementedError(
            f"reading the LLaVA checkpoint in {d} is not ported yet (ROADMAP: "
            "the real Llama-3 tokenizer and safetensors reading); build the "
            "captioner with LlavaCaptioner.from_state_dict")

    @torch.inference_mode()
    def caption(self, image, llava_cfg,
                generator: torch.Generator | None = None,
                noise=None) -> str:
        """Stage 2a on one PIL image; sampling adds `noise(i)` to token i's
        logits, or Gumbel draws from `generator` (default: seeded with 0 on
        the captioner's device); see `generate.generate`."""
        prompt = llava_cfg.img_prompt.format(DEFAULT_IMAGE_TOKEN="<image>")
        cfg = GenerateConfig(max_new_tokens=llava_cfg.max_new_tokens,
                             temperature=llava_cfg.temperature,
                             do_sample=llava_cfg.do_sample)
        encode = lambda s: self.tokenizer.encode(s, add_special_tokens=False)
        decode = lambda ids: self.tokenizer.decode(ids, skip_special_tokens=True)
        self.last_stats = {}
        return caption_image(self.llama, self.vision, self.projector, image,
                             prompt, encode, decode, self.image_newline, cfg,
                             generator, patch_size=self.vision.cfg.image_size,
                             stats=self.last_stats, noise=noise)
