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
int4 decoder in the prefill and in every decode step.

The prefill runs the lm_head on the last real position alone (the full
logits would be [B, s_pad, vocab] in fp32). `generate_batch` (folder
captions) decodes B prompts in one loop: one batched prefill of the
right-padded prompts, then the same step at B rows, each at its own
position and with its own done flag; `caption_images` splices one image
each into the shared prompt.
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


def gumbel_noise(vocab: int, generator: torch.Generator,
                 rows: int | None = None) -> Noise:
    """Gumbel draws [vocab] (or [rows, vocab]) from `generator` on its
    device, as `jax.random.gumbel` makes them: -log(-log(u)), u uniform in
    [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    shape = (vocab,) if rows is None else (rows, vocab)

    def draw(step: int) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(tiny)))
    return draw


@dataclasses.dataclass
class DecodeState:
    """The tensors a decode loop of B rows owns, on the device. `tok`
    [B, 1] is the token each row feeds next, at its own position `pos`
    [B]; `idx` (0-d) is their index in `toks` [max_new_tokens, B];
    `noise` [max_new_tokens, B, vocab] holds every token's draw (zeros
    when greedy, with `temp` 1); `done` [B] turns true at a row's first
    eot and forces eot after it, as JAX's scan does. `runner` replays
    the step."""
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
    """argmax(logits / T + g) over the last axis: the Gumbel-max draw, or
    the greedy token with g = 0 and T = 1. A 0-d divisor: CUDA divides by
    a Python number as a multiply by its reciprocal, which can differ from
    JAX's quotient in the last bit."""
    return torch.argmax(lg.float() / temp + g, dim=-1)


def _is_eot(tok: torch.Tensor, eot: torch.Tensor) -> torch.Tensor:
    """[B] bool: whether each row's token is one of the eot ids."""
    return (tok[:, None] == eot).any(-1)


def decode_step(model: LlamaModel, st: DecodeState, lora: dict | None):
    """One decode step on the device (JAX generate.py's scan body, one
    row per prompt): embed `tok`, write each row's K/V at its `pos`,
    sample the next tokens from their noise rows, record them, advance.
    No host read: the step is captured once and replayed."""
    logits, _ = model(model.embed(st.tok), st.cache, st.pos, lora=lora)
    st.idx.add_(1)
    nxt = _sample(logits[:, -1], st.noise.index_select(0, st.idx)[0], st.temp)
    nxt = torch.where(st.done, st.eot[0], nxt)
    st.done.logical_or_(_is_eot(nxt, st.eot))
    st.toks.index_copy_(0, st.idx.reshape(1), nxt[None])
    st.tok.copy_(nxt[:, None])
    st.pos.add_(1)


def _decode_state(model: LlamaModel, cfg: GenerateConfig, s_pad: int,
                  device: torch.device, rows: int = 1) -> DecodeState:
    long = dict(dtype=torch.long, device=device)
    return DecodeState(
        cache=KVCache.init(model.cfg, rows, s_pad + cfg.max_new_tokens,
                           dtype=model.dtype, device=device),
        tok=torch.zeros((rows, 1), **long), pos=torch.zeros(rows, **long),
        idx=torch.zeros((), **long),
        done=torch.zeros(rows, dtype=torch.bool, device=device),
        toks=torch.zeros((cfg.max_new_tokens, rows), **long),
        noise=torch.zeros((cfg.max_new_tokens, rows, model.cfg.vocab_size),
                          dtype=torch.float32, device=device),
        temp=torch.ones((), dtype=torch.float32, device=device),
        eot=torch.tensor([int(e) for e in cfg.eot_ids], **long))


def _decode(model: LlamaModel, inputs: Sequence[torch.Tensor],
            cfg: GenerateConfig, generator, stats, noise, lora, graphs,
            graph_cache) -> list:
    """The prefill and decode loop of `generate` (one prompt) and
    `generate_batch` (B prompts): a list of np.int32 ids, one per prompt,
    each trimmed at its first eot."""
    b = len(inputs)
    device = inputs[0].device
    graphs = use_graphs(device, graphs)
    lens = [int(e.shape[0]) for e in inputs]
    s_pad = -(-max(lens) // cfg.pad_to) * cfg.pad_to
    key = (s_pad, cfg.max_new_tokens, len(cfg.eot_ids), graphs,
           id(lora) if lora else None, b)
    st = (graph_cache or {}).get(key)
    if st is None:
        st = _decode_state(model, cfg, s_pad, device, b)
        st.runner = StepRunner(lambda: decode_step(model, st, lora), graphs)
        if graph_cache is not None:
            graph_cache[key] = st
    captured = st.runner.capture_s
    # right-padded rows: each row's pad positions hold garbage K/V after the
    # prefill; the causal mask hides them from its position lens[b]-1, and
    # decode overwrites position lens[b]+i before any later query can see it
    embeds = torch.stack([F.pad(e, (0, 0, 0, s_pad - e.shape[0]))
                          for e in inputs])
    st.eot.copy_(torch.tensor([int(e) for e in cfg.eot_ids]))
    if cfg.do_sample and cfg.temperature > 0:
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            noise = gumbel_noise(model.cfg.vocab_size, generator,
                                 None if b == 1 else b)
        for i in range(cfg.max_new_tokens):
            st.noise[i].copy_(noise(i).reshape(b, -1))
        st.temp.fill_(cfg.temperature)
    else:
        st.noise.zero_()
        st.temp.fill_(1.0)

    lens_t = torch.tensor(lens, dtype=torch.long).to(device)
    _sync(device)
    t0 = time.perf_counter()
    # the lm_head on each row's last real position alone (JAX computes the
    # logits of every position and reads them there; the values are equal)
    logits, _ = model(embeds, st.cache, 0, lora=lora, logits_at=lens_t - 1)
    tok = _sample(logits[:, 0], st.noise[0], st.temp)
    st.toks[0].copy_(tok)
    st.tok.copy_(tok[:, None])
    st.done.copy_(_is_eot(tok, st.eot))
    st.pos.copy_(lens_t)
    st.idx.zero_()
    done = bool(st.done.all())  # the prefill's end
    t1 = time.perf_counter()
    steps, total = 0, cfg.max_new_tokens - 1
    while steps < total and not done:
        for _ in range(min(DONE_EVERY, total - steps)):
            st.runner()
            steps += 1
        done = bool(st.done.all())
    ids = st.toks[:steps + 1].cpu().numpy().astype(np.int32)
    if stats is not None:
        stats.update(prompt_len=max(lens), prompt_lens=lens, rows=b,
                     padded_len=s_pad, prefill_s=t1 - t0,
                     decode_s=time.perf_counter() - t1, decode_steps=steps,
                     capture_s=st.runner.capture_s - captured)
    eot = [int(e) for e in cfg.eot_ids]
    outs = []
    for row in ids.T:
        stops = np.isin(row, eot)
        outs.append(row[: int(np.argmax(stops))] if stops.any() else row)
    return outs


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
    loop's tensors and graph per (bucket, lora, rows), so a later call of
    the same bucket captures nothing. `stats`, when given, receives
    prompt_len, padded_len, prefill_s, decode_s, decode_steps (steps run)
    and capture_s (of this call)."""
    return _decode(model, [input_embeds], cfg, generator, stats, noise, lora,
                   graphs, graph_cache)[0]


@torch.inference_mode()
def generate_batch(model: LlamaModel, input_embeds_list: Sequence[torch.Tensor],
                   cfg: GenerateConfig,
                   generator: torch.Generator | None = None,
                   stats: dict | None = None, noise: Noise | None = None,
                   lora: dict | None = None, graphs: bool | None = None,
                   graph_cache: dict | None = None) -> list:
    """B spliced prompts [S_b, D] of any lengths -> B np.int32 id arrays,
    each trimmed at its first eot (JAX generate_batch, generate.py:204-270).
    The prompts are right-padded to one `pad_to` bucket and go through one
    batched prefill from position 0; row b's first token is sampled from
    its logits at lens[b] - 1, and decode step i writes row b at
    lens[b] + i. Each row has its own done flag; the host reads whether
    all are done every DONE_EVERY steps. `noise(i)` gives [B, vocab]
    (JAX's categorical over [B, vocab] draws one Gumbel row per prompt);
    without it, Gumbel draws from `generator`. One prompt runs `generate`,
    as JAX does. Graphs, `graph_cache` and `stats` as in `generate`
    (stats also has prompt_lens and rows)."""
    if len(input_embeds_list) == 1:
        return [generate(model, input_embeds_list[0], cfg, generator, stats,
                         noise, lora, graphs, graph_cache)]
    return _decode(model, list(input_embeds_list), cfg, generator, stats,
                   noise, lora, graphs, graph_cache)


def caption_image(model: LlamaModel, vision_apply, projector_apply, image,
                  prompt_text: str, encode_fn, decode_fn,
                  image_newline: torch.Tensor,
                  cfg: GenerateConfig = GenerateConfig(),
                  generator: torch.Generator | None = None,
                  patch_size: int = 336, stats: dict | None = None,
                  noise: Noise | None = None, lora: dict | None = None,
                  graph_cache: dict | None = None,
                  generate_fn: Callable | None = None) -> str:
    """Stage 2a: anyres -> tower -> projector -> spatial-unpad assembly ->
    splice -> generate -> decode. Sampling noise, `lora` and `graph_cache`
    as in `generate`. generate_fn: a decode with `generate`'s signature in
    its place (JAX generate.py:277-290), such as the speculative one."""
    spliced = embed_multimodal_prompt(
        model, vision_apply, projector_apply, llama3_chat_prompt(prompt_text),
        [image], encode_fn, image_newline, patch_size)
    ids = (generate_fn or generate)(model, spliced, cfg, generator,
                                    stats=stats, noise=noise, lora=lora,
                                    graph_cache=graph_cache)
    return decode_fn(ids.tolist()).lstrip()


def caption_images(model: LlamaModel, vision_apply, projector_apply, images,
                   prompt_text: str, encode_fn, decode_fn,
                   image_newline: torch.Tensor,
                   cfg: GenerateConfig = GenerateConfig(),
                   generator: torch.Generator | None = None,
                   patch_size: int = 336, stats: dict | None = None,
                   noise: Noise | None = None, lora: dict | None = None,
                   graph_cache: dict | None = None) -> list:
    """Batched Stage 2a (JAX caption_images, generate.py:295-314): the
    prompt embedded once, each image's anyres features spliced into it,
    then one `generate_batch` over all of them. Returns one caption per
    image, in order."""
    ids = tokenize_with_image(llama3_chat_prompt(prompt_text), encode_fn)
    safe = torch.from_numpy(np.where(ids == IMAGE_TOKEN_INDEX, 0, ids)).long()
    text_embeds = model.embed(safe.to(image_newline.device))
    spliced = [splice_image_embeds(ids, text_embeds, anyres_image_features(
        vision_apply, projector_apply, image, image_newline,
        patch_size).to(text_embeds.dtype)) for image in images]
    outs = generate_batch(model, spliced, cfg, generator, stats=stats,
                          noise=noise, lora=lora, graph_cache=graph_cache)
    return [decode_fn(o.tolist()).lstrip() for o in outs]
