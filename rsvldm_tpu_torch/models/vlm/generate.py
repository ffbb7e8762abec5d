"""LLaVA caption generation (rsvldm_tpu/models/vlm/generate.py): prompt,
image-feature splice, prefill and a decode loop.

`generate` right-pads the spliced prompt to a multiple of `pad_to`, runs
one prefill from position 0, then one decode step per new token, writing
position s + i. Greedy when do_sample is false or the temperature is 0,
else token i is argmax(logits / T + g_i), the Gumbel-max draw that
`jax.random.categorical` makes, with g_i from `noise(i)`: by default
Gumbel noise from a torch.Generator (its numbers are not JAX's), or any
caller's stream, such as JAX's (`rng` for token 0, `fold_in(rng, i)` after
it), which then gives JAX's ids.

The decode loop is the JAX scan's shape (rsvldm_tpu/models/vlm/generate.py:
180-195) on the device: token, position, done flag, the tokens so far and
every token's noise row live in device tensors that one step function
(`decode_step`) advances, so the step holds no host read. On the card it
is captured once into a CUDA graph and replayed (utils/graphs.py); on the
CPU it is called directly. The host reads the done flag every DONE_EVERY
steps and stops there; the JAX loop runs all max_new_tokens - 1 steps and
forces eot after the first one, and both trim at the first eot, so the ids
are the same. `lora` (adapters by module path, scale folded into
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
from ...utils.graphs import StepRunner, use_graphs
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


# decode steps between two reads of the done flag
DONE_EVERY = 16


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


@dataclasses.dataclass
class DecodeState:
    """The tensors a decode loop owns, on the device. `tok` [1, 1] is the
    token fed next, at position `pos` (0-d); `idx` (0-d) is its index in
    `toks` [max_new_tokens]; `noise` [max_new_tokens, vocab] holds the
    draw of each token (zeros when greedy, with `temp` 1); `done` turns
    true at the first eot and forces eot after it, as JAX's scan does.
    `runner` replays the step."""
    cache: KVCache
    tok: torch.Tensor
    pos: torch.Tensor
    idx: torch.Tensor
    done: torch.Tensor
    toks: torch.Tensor
    noise: torch.Tensor
    temp: torch.Tensor
    eot: torch.Tensor
    runner: StepRunner | None = None


def _sample(lg: torch.Tensor, g: torch.Tensor, temp: torch.Tensor):
    """argmax(logits / T + g): the Gumbel-max draw, or the greedy token
    with g = 0 and T = 1. A 0-d divisor: CUDA divides by a Python number
    as a multiply by its reciprocal, which can differ from JAX's quotient
    in the last bit."""
    return torch.argmax(lg.float() / temp + g)


def decode_step(model: LlamaModel, st: DecodeState, lora: dict | None):
    """One decode step on the device (JAX generate.py's scan body): embed
    `tok`, write its K/V at `pos`, sample the next token from its noise
    row, record it, advance. No host read: the step is captured once and
    replayed."""
    logits, _ = model(model.embed(st.tok), st.cache, st.pos, lora=lora)
    st.idx.add_(1)
    nxt = _sample(logits[0, -1], st.noise.index_select(0, st.idx)[0], st.temp)
    nxt = torch.where(st.done, st.eot[0], nxt)
    st.done.logical_or_((nxt == st.eot).any())
    st.toks.index_copy_(0, st.idx.reshape(1), nxt.reshape(1))
    st.tok.copy_(nxt.reshape(1, 1))
    st.pos.add_(1)


def _decode_state(model: LlamaModel, cfg: GenerateConfig, s_pad: int,
                  device: torch.device) -> DecodeState:
    long = dict(dtype=torch.long, device=device)
    return DecodeState(
        cache=KVCache.init(model.cfg, 1, s_pad + cfg.max_new_tokens,
                           dtype=model.dtype, device=device),
        tok=torch.zeros((1, 1), **long), pos=torch.zeros((), **long),
        idx=torch.zeros((), **long),
        done=torch.zeros((), dtype=torch.bool, device=device),
        toks=torch.zeros(cfg.max_new_tokens, **long),
        noise=torch.zeros((cfg.max_new_tokens, model.cfg.vocab_size),
                          dtype=torch.float32, device=device),
        temp=torch.ones((), dtype=torch.float32, device=device),
        eot=torch.tensor([int(e) for e in cfg.eot_ids], **long))


@torch.inference_mode()
def generate(model: LlamaModel, input_embeds: torch.Tensor,
             cfg: GenerateConfig, generator: torch.Generator | None = None,
             stats: dict | None = None, noise: Noise | None = None,
             lora: dict | None = None, graphs: bool | None = None,
             graph_cache: dict | None = None) -> np.ndarray:
    """input_embeds [S, D] -> np.int32 ids, trimmed at the first eot.
    Sampling adds `noise(i)` [vocab] to the logits of token i; without it,
    Gumbel draws from `generator` (default: seeded with 0 on the
    device); all max_new_tokens draws are made before the loop, in order.
    The decode steps replay one CUDA graph on the card (`graphs`, default
    on CUDA: utils/graphs.py) and the host reads the done flag every
    DONE_EVERY steps. `graph_cache`, a dict the caller keeps, holds the
    loop's tensors and graph per (bucket, lora), so a later call of the
    same bucket captures nothing. `stats`, when given, receives
    prompt_len, padded_len, prefill_s, decode_s, decode_steps (steps run)
    and capture_s (of this call)."""
    device = input_embeds.device
    graphs = use_graphs(device, graphs)
    s = input_embeds.shape[0]
    s_pad = -(-s // cfg.pad_to) * cfg.pad_to
    key = (s_pad, cfg.max_new_tokens, len(cfg.eot_ids), graphs,
           id(lora) if lora else None)
    st = (graph_cache or {}).get(key)
    if st is None:
        st = _decode_state(model, cfg, s_pad, device)
        st.runner = StepRunner(lambda: decode_step(model, st, lora), graphs)
        if graph_cache is not None:
            graph_cache[key] = st
    captured = st.runner.capture_s
    # pad positions hold garbage K/V after the prefill; the causal mask hides
    # them from position s-1, and decode overwrites position s+i before any
    # later query can see it
    embeds = F.pad(input_embeds, (0, 0, 0, s_pad - s))[None]
    st.eot.copy_(torch.tensor([int(e) for e in cfg.eot_ids]))
    if cfg.do_sample and cfg.temperature > 0:
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            noise = gumbel_noise(model.cfg.vocab_size, generator)
        for i in range(cfg.max_new_tokens):
            st.noise[i].copy_(noise(i))
        st.temp.fill_(cfg.temperature)
    else:
        st.noise.zero_()
        st.temp.fill_(1.0)

    _sync(device)
    t0 = time.perf_counter()
    logits, _ = model(embeds, st.cache, 0, lora=lora)
    tok = _sample(logits[0, s - 1], st.noise[0], st.temp)  # last real position
    st.toks[0].copy_(tok)
    st.tok.copy_(tok.reshape(1, 1))
    st.done.copy_((tok == st.eot).any())
    st.pos.fill_(s)
    st.idx.zero_()
    done = bool(st.done)  # the prefill's end
    t1 = time.perf_counter()
    steps, total = 0, cfg.max_new_tokens - 1
    while steps < total and not done:
        for _ in range(min(DONE_EVERY, total - steps)):
            st.runner()
            steps += 1
        done = bool(st.done)
    ids = st.toks[:steps + 1].cpu().numpy().astype(np.int32)
    if stats is not None:
        stats.update(prompt_len=s, padded_len=s_pad, prefill_s=t1 - t0,
                     decode_s=time.perf_counter() - t1, decode_steps=steps,
                     capture_s=st.runner.capture_s - captured)
    stops = np.isin(ids, [int(e) for e in cfg.eot_ids])
    return ids[: int(np.argmax(stops))] if stops.any() else ids


def caption_image(model: LlamaModel, vision_apply, projector_apply, image,
                  prompt_text: str, encode_fn, decode_fn,
                  image_newline: torch.Tensor,
                  cfg: GenerateConfig = GenerateConfig(),
                  generator: torch.Generator | None = None,
                  patch_size: int = 336, stats: dict | None = None,
                  noise: Noise | None = None, lora: dict | None = None,
                  graph_cache: dict | None = None) -> str:
    """Stage 2a: anyres -> tower -> projector -> spatial-unpad assembly ->
    splice -> generate -> decode. Sampling noise, `lora` and `graph_cache`
    as in `generate`."""
    spliced = embed_multimodal_prompt(
        model, vision_apply, projector_apply, llama3_chat_prompt(prompt_text),
        [image], encode_fn, image_newline, patch_size)
    ids = generate(model, spliced, cfg, generator, stats=stats, noise=noise,
                   lora=lora, graph_cache=graph_cache)
    return decode_fn(ids.tolist()).lstrip()
