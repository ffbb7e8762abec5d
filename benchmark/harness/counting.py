"""The work a cell's image asks for, counted from the configuration's
shapes: the bounds of the hand-written kernels K1 (flash attention) and
K2 (the int4 decode product), and the model FLOPs of a whole image.

A kernel's bound is the larger of its operations over the card's peak and
its bytes over the HBM bandwidth (each input byte read once, each output
byte written once); K1's operations count the valid (query, key) pairs,
K2's bytes the bf16 activations in and out, the packed int4 weights and
their fp32 scales. K1's calls are read from the reference itself: its
attention records every call with both sequences at 1024 or more, which
the port sends to K1 on the card, in a forward on the meta device.
Model FLOPs: torch.utils.flop_counter over the reference's modules on the
meta device, and the decoder's in closed form (its products, the
attention over each token's context, the lm_head where the algorithm
needs logits)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import anyres
from reference.attention import recording
from reference.denoiser import ControlDenoiser
from reference.pipeline import family_configs, vision_config
from reference.projector import MLPProjector
from reference.vision import CLIPVisionTower

from . import peaks

K2_GROUP = 128
# the parts of a configuration the reference's modules are built from
FAMILY_KEYS = ("sr3", "sdxl", "vae", "clip_l", "big_g", "refine")


def valid_pairs(sq: int, sk: int, causal: bool) -> int:
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(max(r + off + 1, 0), sk) for r in range(sq))


def k1_cost(b: int, sq: int, sk: int, h: int, d: int, causal: bool) -> dict:
    flops = 4.0 * b * h * d * valid_pairs(sq, sk, causal)
    nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)}


def k2_cost(r: int, inf: int, out: int) -> dict:
    nbytes = float(r * inf * 2 + inf // 2 * out + inf // K2_GROUP * out * 4
                   + r * out * 2)
    ops = 2.0 * r * inf * out
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(nbytes / peaks.HBM_BYTES, ops / peaks.INT8_OPS)}


def decoder_shapes(tc: dict) -> list:
    """[(name, in, out, launches a decode step)] of the int4 projections."""
    d, f = tc["hidden_size"], tc["intermediate_size"]
    hd = d // tc["num_attention_heads"]
    q, kv, n = (tc["num_attention_heads"] * hd,
                tc["num_key_value_heads"] * hd, tc["num_hidden_layers"])
    return [("q_proj", d, q, n), ("k_proj", d, kv, n), ("v_proj", d, kv, n),
            ("o_proj", q, d, n), ("gate_proj", d, f, n), ("up_proj", d, f, n),
            ("down_proj", f, d, n), ("lm_head", d, tc["vocab_size"], 1)]


def k2_step_bound_s(tc: dict) -> float:
    """K2's bound a decode step of one row."""
    return sum(n * k2_cost(1, i, o)["bound_s"] for _, i, o, n in decoder_shapes(tc))


def k2_launches_per_step(tc: dict) -> int:
    return sum(n for *_, n in decoder_shapes(tc))


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


@functools.lru_cache(maxsize=None)
def _denoiser(spec_key):
    spec = _thaw(spec_key)
    fams = family_configs(spec)
    unet = _meta(*fams["unet"])
    control = _meta(*fams["control"])
    return ControlDenoiser(unet=unet, control_net=control)


def _freeze(spec: dict):
    """A hashable key of the parts of spec the counts read."""
    import json
    return tuple(sorted((k, json.dumps(v, sort_keys=True))
                        for k, v in spec.items()))


def _thaw(key) -> dict:
    import json
    return {k: json.loads(v) for k, v in key}


def latent_hw(spec: dict) -> tuple:
    s = spec["refine"]["min_size"]
    return (s // 8, s // 8)


def _denoiser_inputs(spec: dict, n: int = 2):
    h, w = latent_hw(spec)
    m = torch.device("meta")
    sd = spec["sdxl"]
    cond = {"crossattn": torch.empty(n, 77, sd["context_dim"], device=m),
            "vector": torch.empty(n, sd["adm_in_channels"], device=m),
            "control": torch.empty(n, 4, h, w, device=m)}
    return torch.empty(n, 4, h, w, device=m), torch.ones(n, device=m), cond


@functools.lru_cache(maxsize=None)
def _denoiser_counts(key) -> dict:
    """FLOPs and K1 calls of one CFG-doubled denoiser call, split into
    `first` (GLVControl and the UNet input blocks: a cache hit) and `rest`
    (the middle and the decoder: added on a miss)."""
    spec = _thaw(key)
    den = _denoiser(key)
    x, sigma, cond = _denoiser_inputs(spec)
    out = {}
    with torch.no_grad():
        with recording() as calls, FlopCounterMode(display=False) as fc:
            part = den.first(x, sigma, cond)
        out["first"] = {"flops": fc.get_total_flops(), "k1": list(calls)}
        with recording() as calls, FlopCounterMode(display=False) as fc:
            den.rest(part, cond, torch.ones((), device="meta"))
        out["rest"] = {"flops": fc.get_total_flops(), "k1": list(calls)}
    return out


def denoiser_counts(spec: dict) -> dict:
    return _denoiser_counts(_freeze({k: spec[k] for k in FAMILY_KEYS}))


def prefill_k1_calls(tc: dict, padded_len: int) -> list:
    hd = tc["hidden_size"] // tc["num_attention_heads"]
    if padded_len < 1024:
        return []
    return [(1, padded_len, padded_len, tc["num_attention_heads"], hd, True)
            ] * tc["num_hidden_layers"]


def k1_image(spec: dict, hits: int, steps: int, padded_len: int | None) -> dict:
    """K1's launches and bound over one image: `first` every step, `rest`
    on each miss, one a decoder layer in the prefill (padded_len None: no
    caption)."""
    dc = denoiser_counts(spec)
    calls = dc["first"]["k1"] * steps + dc["rest"]["k1"] * (steps - hits)
    if padded_len is not None:
        calls = calls + prefill_k1_calls(spec["text_config"], padded_len)
    return {"launches": len(calls),
            "bound_s": sum(k1_cost(*c)["bound_s"] for c in calls)}


def k2_image(spec: dict, decode_steps: int | None) -> dict:
    """K2's launches and bound over one image's caption: every decode step,
    and the prefill's lm_head on the last position."""
    if decode_steps is None:
        return {"launches": 0, "bound_s": 0.0}
    tc = spec["text_config"]
    lm = k2_cost(1, tc["hidden_size"], tc["vocab_size"])["bound_s"]
    return {"launches": decode_steps * k2_launches_per_step(tc) + 1,
            "bound_s": decode_steps * k2_step_bound_s(tc) + lm}


def decoder_flops(tc: dict, prompt_len: int, new_tokens: int) -> float:
    """The prefill of prompt_len tokens (logits at the last one) and
    new_tokens - 1 decode steps, each token's attention over its context."""
    d, f, v, n = (tc["hidden_size"], tc["intermediate_size"],
                  tc["vocab_size"], tc["num_hidden_layers"])
    h = tc["num_attention_heads"]
    hd = d // h
    q, kv = h * hd, tc["num_key_value_heads"] * hd
    lin = n * (d * q + 2 * d * kv + q * d + 3 * d * f)
    tokens = prompt_len + new_tokens - 1
    ctx = tokens * (tokens + 1) // 2
    return 2.0 * lin * tokens + 4.0 * n * h * hd * ctx + 2.0 * d * v * new_tokens


@functools.lru_cache(maxsize=None)
def _fixed_flops(key) -> dict:
    """FLOPs of the parts whose work does not depend on the run: an SR3
    step, the tower and projector, the text towers, the VAE."""
    spec = _thaw(key)
    fams = family_configs(spec)
    m = torch.device("meta")
    out = {}
    s = spec["sr3"]["image_size"]
    sr3 = _meta(*fams["sr3"])
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            sr3(torch.empty(1, 6, s, s, device=m), torch.ones(1, 1, device=m))
        out["sr3_step"] = fc.get_total_flops()
        vae = _meta(*fams["vae"])
        px = spec["refine"]["min_size"]
        h, w = latent_hw(spec)
        with FlopCounterMode(display=False) as fc:
            x = torch.empty(1, 3, px, px, device=m)
            z = vae.encode_with_denoise(x)
            xs = vae.decode(z)
            vae.encode(xs, noise=torch.empty(1, 4, h, w, device=m))
            vae.decode(torch.empty(1, 4, h, w, device=m))
        out["vae"] = fc.get_total_flops()
        tok = torch.zeros(1, 77, dtype=torch.long, device=m)
        with FlopCounterMode(display=False) as fc:
            for name in ("clip_l", "big_g"):
                t = _meta(*fams[name])
                t(tok)
                t(tok)
        out["text"] = fc.get_total_flops()
        if "text_config" in spec:
            from PIL import Image
            vcfg = vision_config(spec)
            crops = anyres.process_anyres_image(
                Image.new("RGB", (s, s)), vcfg.image_size,
                anyres.grid_pinpoints_for(vcfg.image_size)).shape[0]
            tower = _meta(CLIPVisionTower, vcfg)
            with torch.device("meta"):
                proj = MLPProjector(vcfg.width, spec["text_config"]["hidden_size"],
                                    spec["projector_depth"])
            with FlopCounterMode(display=False) as fc:
                proj(tower(torch.empty(crops, vcfg.image_size,
                                       vcfg.image_size, 3, device=m)))
            out["tower"] = fc.get_total_flops()
    return out


def image_flops(spec: dict, hits: int, steps: int, prompt_len: int | None,
                new_tokens: int | None) -> float:
    """Model FLOPs of one process(): SR3's steps, the caption (tower,
    prefill, decode) when there is one, the conditioning, the denoiser's
    misses and hits at the CFG-doubled batch, the VAE."""
    keys = FAMILY_KEYS + ("vision", "text_config", "projector_depth")
    fixed = _fixed_flops(_freeze({k: spec[k] for k in keys if k in spec}))
    dc = denoiser_counts(spec)
    total = (spec["stage1"]["steps"] * fixed["sr3_step"] + fixed["vae"]
             + fixed["text"] + steps * dc["first"]["flops"]
             + (steps - hits) * dc["rest"]["flops"])
    if prompt_len is not None:
        total += fixed["tower"] + decoder_flops(spec["text_config"],
                                                prompt_len, new_tokens)
    return float(total)
