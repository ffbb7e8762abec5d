"""How `correct` is decided: one image of the window, drawn from the seed,
against the plain reference (benchmark/reference/), run once the window
has closed and the port has been freed, on weights made again from the
seed and noise drawn again from the pipeline seed's key chain.

The reference follows the program stage by stage, each stage from the
program's own input to it, and each stage is judged by itself:
- `sr3_rms`: the Stage-1 PNG against the reference's Stage 1 on the same
  LR tile, rms of the difference in uint8 levels;
- `caption_gap`: each served token's score (logits / T + its Gumbel)
  against the best score the reference gives at its position, over the
  prompt built from the program's Stage-1 image and the served tokens
  before it; the widest gap, in logits;
- `final_rms`: the final PNG against the reference's Stage 2b (VAE, text
  conditioning, RestoreEDM with its own cache decisions, decode, colour
  fix) on the program's Stage-1 PNG and caption, rms in uint8 levels.
The control (`control=True`) puts the reference in the program's place
computed one precision below the configuration's (fp8 e4m3 weights and
inputs of every bf16 Linear and Conv2d; the int4 decoder's int8
activations at int4) and reads the same numbers in the program's place,
so that the run's own comparison with the limits judges it; for the
caption, the gap of the token the control puts first. The program's
numbers are then readings beside them, as "program_" + name."""

from __future__ import annotations

import gc

import numpy as np
import torch
from PIL import Image

from reference import caption as ref_caption
from reference import pipeline as ref
from reference.llama import Decoder, DecoderConfig

from . import weights


def rms_levels(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _module(spec, family, seed, device):
    cls, cfg = ref.family_configs(spec)[family]
    sd = weights.make(weights.family_plan(spec, family), seed, family, device)
    m = ref.build(cls, cfg, sd, device)
    del sd
    return m


def decoder_config(tc: dict) -> DecoderConfig:
    return DecoderConfig(vocab_size=tc["vocab_size"], dim=tc["hidden_size"],
                         layers=tc["num_hidden_layers"],
                         heads=tc["num_attention_heads"],
                         kv_heads=tc["num_key_value_heads"],
                         ffn_dim=tc["intermediate_size"],
                         rope_theta=float(tc["rope_theta"]),
                         rms_eps=float(tc["rms_norm_eps"]),
                         attn_bias=bool(tc.get("attention_bias", False)))


def _chain(pipe_seed: int, call: int, device) -> ref.KeyChain:
    chain = ref.KeyChain(pipe_seed, device)
    chain.skip(call)
    return chain


@torch.no_grad()
def judge(spec: dict, rec: dict, seed: int, pipe_seed: int, tok, device,
          control: bool = False) -> tuple:
    """(numbers, readings) of image record `rec`: the compared numbers
    {name: value}, the program's or, with control, the control's, and the
    other readings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog, low, extra = {}, {}, {}
    sr_png = np.asarray(Image.open(rec["sr3_png"]).convert("RGB"))
    final_png = np.asarray(Image.open(rec["final_png"]).convert("RGB"))

    # Stage 1
    sr3 = _module(spec, "sr3", seed, device)
    ref_sr = ref.stage1(spec, sr3, rec["tile"],
                        _chain(pipe_seed, rec["call"], device))
    prog["sr3_rms"] = rms_levels(sr_png, ref_sr)
    if control:
        ref.lower_precision(sr3)
        out = ref.stage1(spec, sr3, rec["tile"],
                         _chain(pipe_seed, rec["call"], device))
        low["sr3_rms"] = rms_levels(out, ref_sr)
    del sr3
    _free()

    sr_pil = Image.fromarray(sr_png)
    if rec.get("served") is not None:
        p, c = _caption(spec, rec, seed, tok, sr_pil, device, control)
        prog.update(p)
        low.update(c)
        _free()

    # Stage 2b
    m = {f: _module(spec, f, seed, device)
         for f in ("unet", "control", "vae", "clip_l", "big_g")}
    chain = _chain(pipe_seed, rec["call"], device)
    chain.skip_stage1()
    ref_final, hits = ref.refine(spec, m, sr_pil, rec["caption"], chain)
    ref_final = np.asarray(ref_final)
    prog["final_rms"] = rms_levels(final_png, ref_final)
    extra["reference_hits"] = int(np.sum(hits))
    # steps whose cache decision (hit or miss) the reference takes
    # otherwise than the program did
    extra["cache_decisions_apart"] = int(np.sum(
        np.asarray(hits, bool) != np.asarray(rec["dfb"]["trace"], bool)))
    if control:
        for mod in m.values():
            ref.lower_precision(mod)
        chain = _chain(pipe_seed, rec["call"], device)
        chain.skip_stage1()
        out, _ = ref.refine(spec, m, sr_pil, rec["caption"], chain)
        low["final_rms"] = rms_levels(np.asarray(out), ref_final)
    del m
    _free()
    if not control:
        return prog, extra
    extra.update({"program_" + k: v for k, v in prog.items()})
    return low, extra


def _caption(spec, rec, seed, tok, sr_pil, device, control) -> tuple:
    """({"caption_gap": the program's}, {"caption_gap": the control's} or
    {} without control)."""
    sd = weights.make(weights.family_plan(spec, "llava"), seed, "llava", device)
    tower, proj, newline = ref.build_captioner_parts(spec, sd, device)
    dec = Decoder(decoder_config(spec["text_config"]), sd, device)
    del sd
    _free()
    llava = spec["llava"]
    encode = lambda s: tok.encode(s, add_special_tokens=False)
    prompt = ref_caption.prompt_embeds(dec, tower, proj, newline, sr_pil,
                                       llava["img_prompt"], encode,
                                       tower.cfg.image_size)
    temp = llava["temperature"] if llava["do_sample"] else 0.0
    scores = ref_caption.scores(dec, prompt, rec["served"], temp,
                                llava["max_new_tokens"])
    prog = {"caption_gap": float(ref_caption.gaps(scores, rec["served"],
                                                  temp).max())}
    if not control:
        return prog, {}
    ref.lower_precision(tower)
    ref.lower_precision(proj)
    dec.act_qmax = 7
    low_prompt = ref_caption.prompt_embeds(dec, tower, proj, newline, sr_pil,
                                           llava["img_prompt"], encode,
                                           tower.cfg.image_size)
    low = ref_caption.scores(dec, low_prompt, rec["served"], temp,
                             llava["max_new_tokens"])
    picked = low.argmax(-1).cpu().numpy()
    return prog, {"caption_gap": float(ref_caption.gaps(scores, picked,
                                                        temp).max())}
