"""Builder `pipeline`: the port's `SuperResolutionPipeline` with its LLaVA
captioner, built from a configuration through the port's own entry
points: `LlavaCaptioner.from_state_dict(..., quant=)` (the port quantizes
in its set-up) and `SuperResolutionPipeline(state_dicts=..., captioner=...)`,
which fills each family from the seeded state dicts as it builds it.
Nothing is written to disk but the pipeline's own PNGs.

A configuration names its builder (`"builder"` in its file); the image
driver's builder module gives `build(spec, mix, seed, pipe_seed, work,
device) -> (pipeline, tokenizer)`."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from reference.pipeline import tuple_fields

from harness import weights
from harness.tokenizer import StandInTokenizer


def llama_config(tc: dict):
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    return LlamaConfig(vocab_size=tc["vocab_size"], dim=tc["hidden_size"],
                       layers=tc["num_hidden_layers"],
                       heads=tc["num_attention_heads"],
                       kv_heads=tc["num_key_value_heads"],
                       ffn_dim=tc["intermediate_size"],
                       rope_theta=float(tc["rope_theta"]),
                       rms_eps=float(tc["rms_norm_eps"]),
                       attn_bias=bool(tc.get("attention_bias", False)),
                       sliding_window=tc.get("sliding_window"),
                       tie_lm_head=bool(tc.get("tie_word_embeddings", False)))


def pipeline_config(spec: dict, mix: dict, seed: int, work: Path):
    from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                         RefinementConfig, Stage1Config)
    refine_fields = {f.name for f in dataclasses.fields(RefinementConfig)}
    llava = spec["llava"]
    return PipelineConfig(
        output_dir=str(work / "out"), ckpt_dir=str(work / "no_checkpoint"),
        upscale=spec["upscale"], seed=seed,
        no_llava=bool(mix.get("pipeline", {}).get("no_llava", False)),
        stage1=Stage1Config(**tuple_fields(spec["stage1"])),
        llava=LlavaConfig(max_new_tokens=llava["max_new_tokens"],
                          temperature=llava["temperature"],
                          do_sample=llava["do_sample"], quant=llava["quant"],
                          img_prompt=llava["img_prompt"]),
        refine=RefinementConfig(**{k: v for k, v in spec["refine"].items()
                                   if k in refine_fields}))


def model_configs(spec: dict) -> dict:
    from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    return {"sr3": SR3UNetConfig(**tuple_fields(spec["sr3"])),
            "sdxl": SDXLUNetConfig(**tuple_fields(spec["sdxl"])),
            "vae": VAEConfig(**tuple_fields(spec["vae"])),
            "clip_l": CLIPTextConfig(**tuple_fields(spec["clip_l"])),
            "big_g": CLIPTextConfig(**tuple_fields(spec["big_g"]))}


@torch.no_grad()
def build(spec: dict, mix: dict, seed: int, pipe_seed: int, work: Path,
          device):
    """(pipeline, tokenizer): the captioner first, then the pipeline's
    families one by one. The captioner's bf16 state dict is drawn on the
    card and handed to the port from host memory, as a checkpoint's mapped
    files are, so that the card's peak over set-up is the port's own:
    its bf16 decoder, the quantization, the families. Each family's state
    dict is drawn on the card when the port asks for it and dropped once
    that family is filled."""
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    cfg = pipeline_config(spec, mix, pipe_seed, work)
    tok = StandInTokenizer.of(spec)
    cap = None
    if not cfg.no_llava:
        sd = weights.make(weights.family_plan(spec, "llava"), seed, "llava",
                          device, host=device.type == "cuda")
        cap = LlavaCaptioner.from_state_dict(
            sd, llama_config(spec["text_config"]),
            CLIPVisionConfig(**tuple_fields(spec["vision"])), tok,
            quant=spec["llava"]["quant"] or None, device=device)
        del sd
    pipe = SuperResolutionPipeline(
        cfg, device=device, model_cfgs=model_configs(spec),
        state_dicts=weights.SeededStateDicts(spec, seed, device),
        captioner=cap)
    pipe.ensure_stage2()
    return pipe, tok


def runners(pipe) -> list:
    """Every loop step runner the pipeline keeps (Stage 1, RestoreEDM, the
    caption's decode)."""
    found = []

    def walk(v):
        if hasattr(v, "graphs") and hasattr(v, "graph"):
            found.append(v)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif hasattr(v, "runners"):
            walk(list(v.runners.values()))
        elif hasattr(v, "runner"):
            walk(v.runner)
    for v in pipe.loop_graphs.values():
        walk(v)
    if pipe.llava is not None:
        for v in pipe.llava.decode_graphs.values():
            walk(v)
    return found


def uncaptured(pipe) -> int:
    """Runners that would still capture a graph at their next call."""
    return sum(1 for r in runners(pipe) if r.graphs and r.graph is None)
