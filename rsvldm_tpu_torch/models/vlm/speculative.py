"""Speculative caption decoding (rsvldm_tpu/models/vlm/speculative.py).

A draft model proposes k tokens one at a time; the target checks all of
them in one (k+1)-token forward, and the Leviathan rule accepts a prefix:
proposal d at generated index j is kept with probability
min(1, p_t(d) / p_d(d)); the first rejected one is replaced by a draw from
norm(max(p_t - p_d, 0)), and when all k are kept the target's own next
token is added. Greedy (temperature 0) makes every distribution one-hot,
so the ids are exactly the target's greedy ids, for any draft; sampled,
the ids follow the target's distribution, and with draft == target every
proposal is kept and the stream is `generate`'s.

The round is one step function on tensors the loop owns (`SpecState`):
k draft steps, the catch-up feed of the last proposal into the draft's
cache (blocks only: its logits are unused, so no lm_head runs), the
target's verify forward at the device-tensor position `p`, and the
acceptance; it then advances `pending`, `p` and `j0` on the device. On the
card it is captured once into a CUDA graph and replayed
(utils/graphs.StepRunner); the host reads the round's committed tokens and
their count once a round, as JAX's host loop does. Both caches keep
physical slot == position: entries past the commit point are stale and
are overwritten before a query can see them.

Noise per generated index j, in JAX's key schedule (key(0) = rng, key(j)
= fold_in(rng, j)): the proposal Gumbel `noise(j)` (the draw `generate`
makes for token j), and `accept_noise(j)` -> (the acceptance uniform of
fold_in(key(j), 7), the resample Gumbel of fold_in(key(j), 13)). The
round reads them from device tables indexed by j0. By default they come
from a torch.Generator (its numbers are not JAX's). Tokens are drawn as
JAX's `_sample_dist` does: argmax(log p + g) over p > 0.

`self_draft` builds a draft from the target's first N blocks, sharing its
modules (no extra memory); the target's runtime LoRA dict serves it as it
is, since adapters are looked up by block index.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.graphs import StepRunner, use_graphs
from .generate import GenerateConfig, Noise, _sync, gumbel_noise
from .llama import KVCache, LlamaModel, _layer_lora

AcceptNoise = Callable[[int], tuple]


def self_draft(model: LlamaModel, layers: int = 4) -> LlamaModel:
    """The target's first `layers` blocks with its embedding, final norm
    and lm_head as a draft model: the modules are the target's own (the
    same objects), so it costs no memory and follows any quantization."""
    if not 0 < layers < model.cfg.layers:
        raise ValueError(f"self-draft layers must be in 1..{model.cfg.layers - 1}")
    with torch.device("meta"):
        draft = LlamaModel(dataclasses.replace(model.cfg, layers=0))
    draft.cfg = dataclasses.replace(model.cfg, layers=layers)
    draft.model.embed_tokens = model.model.embed_tokens
    draft.model.layers = torch.nn.ModuleList(list(model.model.layers)[:layers])
    draft.model.norm = model.model.norm
    draft.lm_head = model.lm_head
    return draft


def _feed(model: LlamaModel, embeds: torch.Tensor, cache: KVCache,
          start_pos, lora: dict | None):
    """The blocks alone over `embeds`, writing their K/V into `cache`: a
    prefill (start_pos the int 0) or a feed at a device position, for
    which no logits are needed."""
    x = embeds.to(model.dtype)
    for i, block in enumerate(model.model.layers):
        x = block(x, cache.k[i], cache.v[i], start_pos, _layer_lora(lora, i))


def _token_dist(logits: torch.Tensor, temp: torch.Tensor, greedy: bool):
    """The token distribution over the last axis, fp32: one-hot at the
    argmax when greedy, else softmax(logits / max(T, 1e-6)) computed as
    exp(x - max) / sum (JAX's softmax)."""
    if greedy:
        hot = torch.zeros_like(logits, dtype=torch.float32)
        return hot.scatter_(-1, logits.argmax(-1, keepdim=True), 1.0)
    x = logits.float() / temp.clamp_min(1e-6)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _sample_dist(probs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """argmax(log p + g) over p > 0: JAX's categorical over log-probs."""
    logp = torch.where(probs > 0, probs.log(),
                       torch.full_like(probs, float("-inf")))
    return torch.argmax(logp + g, dim=-1)


def accept_and_correct(d_toks, d_dists, t_dists, u, resample, bonus):
    """The acceptance and correction (JAX accept_and_correct): d_toks [k]
    proposals, d_dists [k, V] their draft distributions, t_dists [k+1, V]
    the target's; u [k] the acceptance uniforms, resample [k, V] the
    resample Gumbel rows, bonus [V] the Gumbel row of index j0 + k. Returns
    (committed [k+1] long, n_commit 0-d): the accepted prefix, then the
    correction (or the bonus token when all k are kept) at n_commit - 1."""
    k = d_toks.shape[0]
    rows = torch.arange(k, device=d_toks.device)
    ratio = t_dists[rows, d_toks] / d_dists[rows, d_toks].clamp_min(1e-30)
    n_acc = torch.cumprod((u < ratio).long(), 0).sum()
    t_na = t_dists.index_select(0, n_acc.reshape(1))[0]
    at = n_acc.clamp(max=k - 1).reshape(1)  # unused when all are kept
    resid = (t_na - d_dists.index_select(0, at)[0]).clamp_min(0.0)
    resid = resid / resid.sum().clamp_min(1e-30)
    full = n_acc == k
    corr = _sample_dist(torch.where(full, t_na, resid),
                        torch.where(full, bonus, resample.index_select(0, at)[0]))
    committed = torch.cat([d_toks, d_toks.new_zeros(1)])
    committed.scatter_(0, n_acc.reshape(1), corr.reshape(1))
    return committed, n_acc + 1


@dataclasses.dataclass
class SpecState:
    """The tensors a speculative loop owns, on the device: both caches,
    `pending` [1, 1] (the last committed token, not yet fed), `p` (0-d, the
    position it is fed at), `j0` (0-d, the generated index of the round's
    first new token), the noise tables by generated index (`gumbel`
    [J, V], `uniform` [J], `resample` [J, V]; zeros when greedy), `temp`
    (0-d), and `out` [k+2]: the round's committed tokens, then their
    count. `runner` replays the round."""
    cache_t: KVCache
    cache_d: KVCache
    pending: torch.Tensor
    p: torch.Tensor
    j0: torch.Tensor
    gumbel: torch.Tensor
    uniform: torch.Tensor
    resample: torch.Tensor
    temp: torch.Tensor
    out: torch.Tensor
    runner: StepRunner | None = None


def spec_round(target: LlamaModel, draft: LlamaModel, st: SpecState, k: int,
               greedy: bool, lora: dict | None, draft_lora: dict | None):
    """One round on the device (JAX make_round_fn's body), no host read:
    k proposals, the catch-up feed, one verify forward of k+1 tokens at
    `p`, the acceptance; writes `out` and advances pending, p and j0."""
    tok, toks, dists = st.pending, [], []
    for i in range(k):
        lg, _ = draft(draft.embed(tok), st.cache_d, st.p + i, lora=draft_lora)
        dist = _token_dist(lg[0, -1], st.temp, greedy)
        nxt = _sample_dist(dist, st.gumbel.index_select(0, (st.j0 + i).reshape(1))[0])
        toks.append(nxt)
        dists.append(dist)
        tok = nxt.reshape(1, 1)
    # the last proposal into the draft's cache, so that it covers the block
    _feed(draft, draft.embed(tok), st.cache_d, st.p + k, draft_lora)
    d_toks = torch.stack(toks)
    block = torch.cat([st.pending.reshape(1), d_toks])[None]
    t_logits, _ = target(target.embed(block), st.cache_t, st.p, lora=lora)
    t_dists = _token_dist(t_logits[0], st.temp, greedy)
    idx = st.j0 + torch.arange(k + 1, device=st.j0.device)
    committed, n_commit = accept_and_correct(
        d_toks, torch.stack(dists), t_dists, st.uniform.index_select(0, idx[:k]),
        st.resample.index_select(0, idx[:k]), st.gumbel.index_select(0, idx[k:])[0])
    st.out[:k + 1].copy_(committed)
    st.out[k + 1].copy_(n_commit)
    st.pending.copy_(committed.index_select(0, (n_commit - 1).reshape(1))[None])
    st.p.add_(n_commit)
    st.j0.add_(n_commit)


def _spec_state(target: LlamaModel, draft: LlamaModel, cfg: GenerateConfig,
                s_pad: int, k: int, device: torch.device) -> SpecState:
    # a round's block may run past max_new_tokens (JAX's cache length)
    total = s_pad + cfg.max_new_tokens + k + 1
    rows, vocab = cfg.max_new_tokens + k, target.cfg.vocab_size
    long = dict(dtype=torch.long, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SpecState(
        cache_t=KVCache.init(target.cfg, 1, total, dtype=target.dtype, device=device),
        cache_d=KVCache.init(draft.cfg, 1, total, dtype=draft.dtype, device=device),
        pending=torch.zeros((1, 1), **long), p=torch.zeros((), **long),
        j0=torch.zeros((), **long), gumbel=torch.zeros((rows, vocab), **f32),
        uniform=torch.zeros(rows, **f32),
        resample=torch.zeros((rows, vocab), **f32),
        temp=torch.ones((), **f32), out=torch.zeros(k + 2, **long))


def default_accept_noise(vocab: int, generator: torch.Generator) -> AcceptNoise:
    """(uniform in [0, 1), Gumbel [vocab]) per index from `generator`."""
    gumbel = gumbel_noise(vocab, generator)

    def draw(j: int):
        u = torch.rand((), generator=generator, device=generator.device)
        return u, gumbel(j)
    return draw


@torch.inference_mode()
def speculative_generate(target: LlamaModel, draft: LlamaModel,
                         input_embeds: torch.Tensor, cfg: GenerateConfig,
                         k: int = 4, generator: torch.Generator | None = None,
                         noise: Noise | None = None,
                         accept_noise: AcceptNoise | None = None,
                         draft_embeds: torch.Tensor | None = None,
                         stats: dict | None = None, lora: dict | None = None,
                         draft_lora: dict | None = None,
                         graphs: bool | None = None,
                         graph_cache: dict | None = None) -> np.ndarray:
    """`generate` with a draft: [S, D] spliced prompt -> np.int32 ids,
    trimmed at the first eot, at most max_new_tokens. draft_embeds: the
    prompt in the draft's embedding space (default input_embeds, as for a
    draft that shares the tokenizer and width). Sampling noise per index j:
    `noise(j)` and `accept_noise(j)` (module docstring); without them,
    draws from `generator` (default: seeded with 0 on the device), all made
    before the loop. `lora` rides the target, `draft_lora` the draft.
    `graph_cache` keeps the loop's tensors and graph per (bucket, k,
    greedy, loras, draft). `stats`, when given, receives rounds, proposed,
    accepted (draft tokens kept), accept_rate, prompt_len, padded_len,
    prefill_s, decode_s, tokens, and capture_s and the rounds replayed
    from the graph (`replays`) of this call."""
    device = input_embeds.device
    graphs = use_graphs(device, graphs)
    greedy = not (cfg.do_sample and cfg.temperature > 0)
    s = int(input_embeds.shape[0])
    s_pad = -(-s // cfg.pad_to) * cfg.pad_to
    key = ("spec", s_pad, cfg.max_new_tokens, k, greedy, graphs,
           id(lora) if lora else None, id(draft_lora) if draft_lora else None,
           id(draft))
    st = (graph_cache or {}).get(key)
    if st is None:
        st = _spec_state(target, draft, cfg, s_pad, k, device)
        st.runner = StepRunner(lambda: spec_round(target, draft, st, k, greedy,
                                                  lora, draft_lora), graphs)
        if graph_cache is not None:
            graph_cache[key] = st
    captured, replayed = st.runner.capture_s, st.runner.replays
    if greedy:
        for t in (st.gumbel, st.uniform, st.resample):
            t.zero_()
        st.temp.fill_(1.0)
    else:
        vocab = target.cfg.vocab_size
        if noise is None or accept_noise is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            noise = noise or gumbel_noise(vocab, generator)
            accept_noise = accept_noise or default_accept_noise(vocab, generator)
        for j in range(st.gumbel.shape[0]):
            st.gumbel[j].copy_(noise(j).reshape(-1))
        for j in range(st.gumbel.shape[0]):
            u, r = accept_noise(j)
            st.uniform[j].copy_(torch.as_tensor(u))
            st.resample[j].copy_(r.reshape(-1))
        st.temp.fill_(cfg.temperature)

    pad = lambda e: F.pad(e, (0, 0, 0, s_pad - s))[None]
    _sync(device)
    t0 = time.perf_counter()
    logits, _ = target(pad(input_embeds), st.cache_t, 0, lora=lora,
                       logits_at=torch.tensor([s - 1], device=device))
    _feed(draft, pad(input_embeds if draft_embeds is None else draft_embeds),
          st.cache_d, 0, draft_lora)
    tok0 = _sample_dist(_token_dist(logits[0, 0], st.temp, greedy), st.gumbel[0])
    st.pending.copy_(tok0.reshape(1, 1))
    st.p.fill_(s)
    st.j0.fill_(1)
    eot = {int(e) for e in cfg.eot_ids}
    out = [int(tok0)]
    if out[0] in eot:
        out = []
    t1 = time.perf_counter()
    rounds = accepted = 0
    while out and len(out) < cfg.max_new_tokens:
        st.runner()
        res = st.out.cpu().tolist()
        n_c = res[k + 1]
        rounds += 1
        accepted += n_c - 1  # the last one is the correction or the bonus
        stop = False
        for t in res[:n_c]:
            out.append(t)
            if t in eot:
                out.pop()
                stop = True
                break
            if len(out) >= cfg.max_new_tokens:
                stop = True
                break
        if stop:
            break
    if stats is not None:
        stats.update(rounds=rounds, proposed=k * rounds, accepted=accepted,
                     accept_rate=accepted / (k * rounds) if rounds else 0.0,
                     spec_k=k, prompt_len=s, padded_len=s_pad, prefill_s=t1 - t0,
                     decode_s=time.perf_counter() - t1, tokens=len(out),
                     capture_s=st.runner.capture_s - captured,
                     replays=st.runner.replays - replayed)
    return np.asarray(out, np.int32)
