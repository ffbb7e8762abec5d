"""LLaVA caption generation (rsvldm_tpu/models/vlm/generate.py): prompt,
image-feature splice, prefill and a decode loop.

`generate` right-pads the spliced prompt to a multiple of `pad_to`, runs
one prefill from position 0, then one decode step per new token, writing
position s + i. Greedy when do_sample is false or the temperature is 0,
else token i is argmax(logits / T + g_i), the Gumbel-max draw that
`jax.random.categorical` makes, with g_i from `noise(i)`: by default
Gumbel noise from a torch.Generator (its numbers are not JAX's), or any
caller's stream, such as JAX's (`rng` for token 0, `fold_in(rng, i)` after
it), which then gives JAX's ids. The JAX loop runs all max_new_tokens - 1
steps and forces eot after the first one; this loop stops there, which
returns the same ids. `lora` (adapters by module path, scale folded into
b: training/vlm_trainer.runtime_lora) rides the runtime branch of an int8 /
int4 decoder in the prefill and in every decode step. Not ported yet:
batched decode (generate_batch, caption_images).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import anyres
from .llama import KVCache, LlamaModel
from .vision import normalize_pixels

IMAGE_TOKEN_INDEX = -200     # llava/constants.py
DEFAULT_IMAGE_TOKEN = "<image>"
LLAMA3_EOT = 128009          # <|eot_id|>

SYSTEM_PROMPT = ("You are a helpful language and vision assistant. "
                 "You are able to understand the visual content that the user "
                 "provides, and assist the user with a variety of tasks using "
                 "natural language.")


def render_llama3_chat(turns, system: str = SYSTEM_PROMPT) -> str:
    """The llama-3 chat template with the generation header; turns are
    (role, message) pairs."""
    out = ["<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
           f"{system}<|eot_id|>"]
    for role, msg in turns:
        out.append(f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                   f"{msg}<|eot_id|>")
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def llama3_chat_prompt(user_message: str, system: str = SYSTEM_PROMPT) -> str:
    return render_llama3_chat([("user", user_message)], system)


def tokenize_with_image(prompt: str, encode_fn: Callable[[str], list],
                        image_token_index: int = IMAGE_TOKEN_INDEX) -> np.ndarray:
    """Token ids with the sentinel at each <image>; encode_fn adds no
    special tokens."""
    chunks = [encode_fn(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: list[int] = list(chunks[0])
    for chunk in chunks[1:]:
        ids.append(image_token_index)
        ids.extend(chunk)
    return np.asarray(ids, dtype=np.int32)


def anyres_image_features(vision_apply, projector_apply, image,
                          image_newline: torch.Tensor,
                          patch_size: int = 336) -> torch.Tensor:
    """One PIL image -> its anyres spatial-unpad token stream [T, D] on the
    newline's device, in its dtype."""
    grid = anyres.grid_pinpoints_for(patch_size)
    patches = anyres.process_anyres_image(image, patch_size, grid)
    px = torch.from_numpy(patches).to(image_newline.device)
    feats = projector_apply(vision_apply(normalize_pixels(px)))
    tokens = anyres.assemble_spatial_unpad(
        feats.float().cpu().numpy(), image.size,
        image_newline.float().cpu().numpy(), grid, patch_size)
    return torch.from_numpy(tokens).to(image_newline.device, image_newline.dtype)


def embed_multimodal_prompt(model: LlamaModel, vision_apply, projector_apply,
                            prompt_text: str, images, encode_fn,
                            image_newline: torch.Tensor,
                            patch_size: int = 336) -> torch.Tensor:
    """Rendered prompt + PIL images (one per <image>) -> spliced [S, D]."""
    ids = tokenize_with_image(prompt_text, encode_fn)
    device = image_newline.device
    safe = torch.from_numpy(np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)).long()
    text_embeds = model.embed(safe.to(device))
    positions = np.where(ids == IMAGE_TOKEN_INDEX)[0]
    if len(positions) != len(images):
        raise ValueError(f"{len(images)} images for {len(positions)} "
                         f"{DEFAULT_IMAGE_TOKEN} tokens in the prompt")
    segs, prev = [], 0
    for pos, image in zip(positions, images):
        toks = anyres_image_features(vision_apply, projector_apply, image,
                                     image_newline, patch_size)
        segs += [text_embeds[prev:int(pos)], toks.to(text_embeds.dtype)]
        prev = int(pos) + 1
    segs.append(text_embeds[prev:])
    return torch.cat(segs, dim=0)


def splice_image_embeds(token_ids: np.ndarray, text_embeds: torch.Tensor,
                        image_features: torch.Tensor) -> torch.Tensor:
    """Replace the single sentinel position with the image token stream."""
    pos = int(np.where(token_ids == IMAGE_TOKEN_INDEX)[0][0])
    return torch.cat([text_embeds[:pos], image_features,
                      text_embeds[pos + 1:]], dim=0)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 256
    temperature: float = 0.2
    do_sample: bool = True
    eot_ids: Sequence[int] = (LLAMA3_EOT,)
    pad_to: int = 128             # prompt-length bucket


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


Noise = Callable[[int], torch.Tensor]


def gumbel_noise(vocab: int, generator: torch.Generator) -> Noise:
    """Gumbel draws [vocab] from `generator` on its device, as
    `jax.random.gumbel` makes them: -log(-log(u)), u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int) -> torch.Tensor:
        u = torch.rand(vocab, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(tiny)))
    return draw


@torch.inference_mode()
def generate(model: LlamaModel, input_embeds: torch.Tensor,
             cfg: GenerateConfig, generator: torch.Generator | None = None,
             stats: dict | None = None, noise: Noise | None = None,
             lora: dict | None = None) -> np.ndarray:
    """input_embeds [S, D] -> np.int32 ids, trimmed at the first eot.
    Sampling adds `noise(i)` [vocab] to the logits of token i; without it,
    Gumbel draws from `generator` (default: seeded with 0 on the
    device). `stats`, when given, receives prompt_len, padded_len,
    prefill_s, decode_s and decode_steps."""
    device = input_embeds.device
    s = input_embeds.shape[0]
    s_pad = -(-s // cfg.pad_to) * cfg.pad_to
    # pad positions hold garbage K/V after the prefill; the causal mask hides
    # them from position s-1, and decode overwrites position s+i before any
    # later query can see it
    embeds = F.pad(input_embeds, (0, 0, 0, s_pad - s))[None]
    cache = KVCache.init(model.cfg, 1, s_pad + cfg.max_new_tokens,
                         dtype=model.dtype, device=device)
    sampled = cfg.do_sample and cfg.temperature > 0
    if sampled and noise is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        noise = gumbel_noise(model.cfg.vocab_size, generator)
    # a 0-d divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which can differ from JAX's quotient in the last bit
    temp = torch.tensor(cfg.temperature, dtype=torch.float32, device=device)

    def sample(lg, i):
        if sampled:
            g = noise(i).to(device=device, dtype=torch.float32)
            return int(torch.argmax(lg.float() / temp + g))
        return int(torch.argmax(lg))

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model(embeds, cache, 0, lora=lora)
    tok = sample(logits[0, s - 1], 0)  # last real prompt position
    _sync(device)
    t1 = time.perf_counter()
    eot = set(int(e) for e in cfg.eot_ids)
    out = [tok]
    steps = 0
    while tok not in eot and len(out) < cfg.max_new_tokens:
        emb = model.embed(torch.tensor([[tok]], device=device))
        logits, cache = model(emb, cache, s + steps, lora=lora)
        steps += 1
        tok = sample(logits[0, -1], steps)
        out.append(tok)
    _sync(device)
    if stats is not None:
        stats.update(prompt_len=s, padded_len=s_pad, prefill_s=t1 - t0,
                     decode_s=time.perf_counter() - t1, decode_steps=steps)
    ids = np.asarray(out, dtype=np.int32)
    stops = np.isin(ids, list(eot))
    return ids[: int(np.argmax(stops))] if stops.any() else ids


def caption_image(model: LlamaModel, vision_apply, projector_apply, image,
                  prompt_text: str, encode_fn, decode_fn,
                  image_newline: torch.Tensor,
                  cfg: GenerateConfig = GenerateConfig(),
                  generator: torch.Generator | None = None,
                  patch_size: int = 336, stats: dict | None = None,
                  noise: Noise | None = None, lora: dict | None = None) -> str:
    """Stage 2a: anyres -> tower -> projector -> spatial-unpad assembly ->
    splice -> generate -> decode. Sampling noise and `lora` as in
    `generate`."""
    spliced = embed_multimodal_prompt(
        model, vision_apply, projector_apply, llama3_chat_prompt(prompt_text),
        [image], encode_fn, image_newline, patch_size)
    ids = generate(model, spliced, cfg, generator, stats=stats, noise=noise,
                   lora=lora)
    return decode_fn(ids.tolist()).lstrip()
