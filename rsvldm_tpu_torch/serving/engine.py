"""Continuous-batching LLM decode engine (rsvldm_tpu/serving/engine.py).

A fixed pool of `slots` rows backs one KV cache [L, slots, max_len, kvh,
hd], allocated once; requests join and leave the batch between steps:
- `submit` queues a spliced prompt [S, D]; its padded bucket (`pad_to`)
  plus max_new_tokens must fit `max_len`.
- Admission zeroes the slot's row of the pool and prefills the padded
  prompt into it from position 0 (through ops/attention.py: K1 on the card
  from 1024 tokens), the lm_head on the last real position alone (JAX
  computes every position's logits and reads that one: the values are the
  same), then samples token 0.
- `register_prefix` prefills a shared prefix [P, D] once and keeps its KV
  block; `submit(suffix, prefix_id=)` copies that block into the slot's
  zeroed row and prefills only the suffix, at offset P (the general
  einsum path, as JAX's traced offset takes). Positions P..P_pad hold
  prefix padding that the suffix overwrites before a query reaches them.
- Chunked prefill (`prefill_chunk=C`): a prompt longer than C fills a row
  cache of its own C tokens per `step()` (the einsum path, even for the
  first chunk), every other slot decoding in between; the last chunk's
  lm_head row gives token 0 and the row is copied into the pool.
- One decode step advances every slot at its own position. Free slots
  decode on frozen positions into rows the next admission zeroes; a padded
  prompt's tail sits in the causal future and is overwritten before the
  frontier reaches it.
- The decode horizon (`decode_horizon=H`) runs H steps in one call when
  nothing waits (no queued request, no chunked prefill) and some row has H
  tokens left; rows that stop inside it are trimmed on the host.
- Speculative rounds (`draft=`, `spec_k=k`): k draft steps at every
  slot's position, the catch-up feed (blocks only), one (k+1)-token verify
  of the target over all slots, and the Leviathan acceptance per row
  (models/vlm/speculative.py::accept_and_correct); each slot commits 1..k+1
  tokens a round.

The scheduler's state enters each step as device tensors [B] updated in
place (tokens, positions, nonces, counts; temperatures), so a step, a
horizon and a round are each one function with no host read: on the card
they are captured once into CUDA graphs and replayed (utils/graphs.py;
`warmup` captures them all before a worker serves, so handler threads that
embed prompts meanwhile never meet a capture). The host reads the tokens
once after each step, horizon or round.

Sampling follows JAX's `_sample` per row: argmax where the temperature is
0, else argmax(logits / max(T, 1e-6) + g). The draws are keyed by
(request nonce, generated index), never by slot, so a request's stream does
not depend on its slot or its co-tenants. They come from a `noise` object:
`gumbel(nonces, counts) -> [B, V]`, and for speculative rounds
`uniform(nonces, counts) -> [B]` (the acceptance draw) and
`resample(nonces, counts) -> [B, V]` (the correction's Gumbel), JAX's
fold_in(key, 7) and fold_in(key, 13). The default, `FoldedNoise`, draws
JAX's numbers: the rows of fold_in(fold_in(key, nonce), count) with
`key` the engine's (default PRNGKey(0), as JAX's `rng`), keyed on the
device from the nonce and count tensors (utils/prng.py::draw_folded, one
launch of the threefry kernel a table), so a replayed graph draws the rows
of the counts it is given. A step draws its Gumbels in one table, a
horizon all of its steps' in one, a round its proposals' and bonus'
Gumbels, acceptance uniforms and resample Gumbels in three.

The pools' format is one decision, `kv_8bit` (or the model's own
cfg.kv_quant): int8 K/V with fp32 scale planes for the slot pool, the
prefix blocks, the chunk rows and the draft's pool; else the model's dtype.

Tensor parallelism (`mesh=`, JAX's `DecodeEngine(mesh=)`): the decoder,
and the draft, are sharded over the mesh's 'data' group
(parallel/llama_sharding.py::shard_llama_; a model built sharded, as
`build_sharded_llama` builds it, is taken as it is), and every pool holds
the rank's kv heads (shard_kv_cache's cut; kv heads that do not divide
the group leave the attention and the pools whole). JAX runs one
process; the port runs one a rank, in lockstep. Rank 0 owns the queue:
`submit`, `step`, `generate_all`, `register_prefix` and a worker's HTTP
threads run there. Each device operation it starts (an admission with its
embeddings, a registered prefix, the chunked prefills' advance, a decode
step, horizon or round) is first broadcast as a plan entry
(parallel/distributed.py::broadcast) to the other ranks, which run
`follow()`: the same bookkeeping and the same device work, until rank 0
sends the stop (`stop_followers`). The tokens of every step are rank 0's,
broadcast after it: each rank commits the same streams, and a rank whose
own sampled tokens differ counts it in `disagreements`. Steps under TP
run directly, without CUDA graphs (their collectives are not captured).
A group of one leaves the model whole and the engine as without a mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.vlm.generate import GenerateConfig
from ..models.vlm.llama import KVCache, LlamaModel
from ..models.vlm.speculative import (_feed, _sample_dist, _token_dist,
                                      accept_and_correct)
from ..parallel.distributed import broadcast
from ..parallel.llama_sharding import shard_llama_
from ..utils import prng
from ..utils.graphs import StepRunner, use_graphs

# plan entries rank 0 sends to the other ranks of a tensor-parallel engine
(_STOP, _ADMIT, _CHUNKS, _STEP, _PREFIX, _DROP, _FAIL) = range(7)
_DECODE, _HORIZON, _SPEC = range(3)  # a _STEP's kind
_PLAN_LEN = 16


@dataclasses.dataclass
class _Request:
    uid: int
    embeds: Any                 # [S, D] spliced prompt embeddings
    max_new_tokens: int
    temperature: float
    eot_ids: tuple
    nonce: int
    prefix_id: int | None = None
    # chunked-prefill state (engine.prefill_chunk): a row cache of its own
    # filled one chunk per step() before the slot joins the decode batch
    row: Any = None
    chunk_emb: Any = None
    base_off: int = 0
    chunk_i: int = 0
    n_chunks: int = 0
    out_ids: list = dataclasses.field(default_factory=list)
    slot: int = -1
    prompt_len: int = 0
    done: bool = False
    error: str | None = None
    t_submit: float = 0.0
    t_first: float | None = None
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)


class FoldedNoise:
    """JAX's engine draws from `key`: nonces and counts are long tensors of
    one shape on the device, and row (n, c) is drawn from fold_in(fold_in(
    key, n), c) (the acceptance uniform and the resample Gumbels fold 7 and
    13 onto it), so a request gets the same draws in any slot. Each call is
    one draw over all the rows, with no host read."""

    def __init__(self, vocab: int, key: prng.Key | None = None):
        self.vocab = vocab
        self.key = prng.key(0) if key is None else key

    def _draw(self, nonces, counts, fold, shape, dist) -> torch.Tensor:
        words = [nonces, counts]
        if fold is not None:
            words.append(torch.full_like(nonces, fold))
        folds = torch.stack(words, -1).reshape(-1, len(words))
        out = prng.draw_folded(self.key, folds, shape, dist)
        return out.reshape(*nonces.shape, *shape)

    def gumbel(self, nonces, counts) -> torch.Tensor:
        """[*, V] Gumbels of fold_in(fold_in(key, nonce), count)."""
        return self._draw(nonces, counts, None, (self.vocab,), "gumbel")

    def uniform(self, nonces, counts) -> torch.Tensor:
        """[*] acceptance uniforms, fold 7."""
        return self._draw(nonces, counts, 7, (), "uniform")

    def resample(self, nonces, counts) -> torch.Tensor:
        """[*, V] resample Gumbels, fold 13."""
        return self._draw(nonces, counts, 13, (self.vocab,), "gumbel")


def _sample(lg: torch.Tensor, temps: torch.Tensor, g: torch.Tensor):
    """Per row (JAX engine.py:119-124): argmax(lg / max(T, 1e-6) + g) where
    T > 0, argmax(lg) elsewhere. lg [B, V], temps [B], g [B, V]."""
    safe = temps.clamp_min(1e-6)
    samp = torch.argmax(lg.float() / safe[:, None] + g, dim=-1)
    return torch.where(temps > 0, samp, torch.argmax(lg, dim=-1))


def _token_dists(lg: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """JAX `_token_dist` with one temperature per row (lg [B, ..., V]):
    the softmax at T where T > 0, the one-hot argmax elsewhere."""
    t = temps.reshape(-1, *([1] * (lg.dim() - 1)))
    return torch.where(t > 0, _token_dist(lg, t, False),
                       _token_dist(lg, t, True))


def _pad_rows(emb: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(emb, (0, 0, 0, n - emb.shape[0]))


class DecodeEngine:
    """Slot-pool continuous-batching decoder over a LlamaModel.

    model: the (possibly quantized) decoder, on its device; slots: the
    concurrent sequences; max_len: each slot's cache length (prompt and
    generation). kv_8bit: int8 pools with scale planes (as the model's
    cfg.kv_quant gives), else pools in the model's dtype. noise: the draws
    (module docstring; default FoldedNoise of `key`, a utils/prng key,
    default PRNGKey(0) as JAX's `rng`; nonces start at 1 as JAX's). On the
    card the step, the horizon and the round replay CUDA graphs."""

    def __init__(self, model: LlamaModel, slots: int = 4,
                 max_len: int = 4096, pad_to: int = 128, kv_8bit: bool = False,
                 noise=None, prefill_chunk: int | None = None,
                 draft: LlamaModel | None = None, spec_k: int = 4, mesh=None,
                 decode_horizon: int = 1, key: prng.Key | None = None):
        """draft/spec_k: speculative rounds; the draft must share the
        target's hidden size (its prefill takes the same spliced embeds).
        They compose with neither prefix caching nor chunked prefill nor
        the decode horizon, as in JAX. mesh: tensor parallelism over the
        mesh's 'data' group (module docstring): every rank of the group
        builds the engine, rank 0 serves and the others call follow()."""
        self._group, self._rank = None, 0
        self.disagreements = 0
        if mesh is not None:
            group = mesh.get_group("data")
            if dist.get_world_size(group) > 1:
                self._group, self._rank = group, dist.get_rank(group)
                model = model if model.tp is not None else shard_llama_(
                    model, group)
                if draft is not None and draft.tp is None:
                    draft = shard_llama_(draft, group)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.pad_to = pad_to
        if prefill_chunk is not None and prefill_chunk % pad_to:
            raise ValueError("prefill_chunk must be a multiple of pad_to")
        if draft is not None and prefill_chunk is not None:
            raise ValueError("speculative decoding does not compose with "
                             "prefill_chunk")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if draft is not None and decode_horizon > 1:
            raise ValueError("speculative decoding does not compose with "
                             "decode_horizon (a spec round already commits "
                             "up to k+1 tokens per dispatch)")
        if draft is not None and draft.cfg.dim != model.cfg.dim:
            raise ValueError(
                f"draft hidden dim {draft.cfg.dim} != target "
                f"{model.cfg.dim} — the draft prefill consumes the "
                "target's spliced embeds")
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = decode_horizon
        self.draft = draft
        self.spec_k = spec_k
        dev = model.model.norm.weight.device
        self.device = dev
        # a step that holds collectives runs directly
        self.graphs = use_graphs(dev, None) and self._group is None
        self.noise = noise or FoldedNoise(model.cfg.vocab_size, key)
        quant = lambda cfg: (dataclasses.replace(cfg, kv_quant=True)
                             if kv_8bit else cfg)
        # cache_cfg: the rank's kv heads on a sharded attention
        self._kv_cfg = quant(model.cache_cfg)
        self.cache = self._new_cache(slots, max_len)
        self.draft_cache = (KVCache.init(quant(draft.cache_cfg), slots,
                                         max_len, draft.dtype, dev)
                            if draft is not None else None)
        long = dict(dtype=torch.long, device=dev)
        # the scheduler's state a step reads: toks, pos, nonces, counts
        self._state = torch.zeros((4, slots), **long)
        self._temps = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._outs = {"decode": torch.zeros((slots, 1), **long)}
        runners = {"decode": lambda: self._decode_body(1, self._outs["decode"])}
        if decode_horizon > 1:
            self._outs["horizon"] = torch.zeros((slots, decode_horizon), **long)
            runners["horizon"] = lambda: self._decode_body(
                decode_horizon, self._outs["horizon"])
        if draft is not None:
            self._outs["spec"] = torch.zeros((slots, spec_k + 2), **long)
            runners["spec"] = lambda: self._spec_body(self._outs["spec"])
        self.runners = {name: StepRunner(fn, self.graphs)
                        for name, fn in runners.items()}
        # the three dispatches step() makes (swappable by tests)
        self._decode = lambda: self._run("decode")
        self._decode_multi = lambda: self._run("horizon")
        self._spec_round = lambda: self._run("spec")

        self._free = list(range(slots))
        self._active: dict[int, _Request] = {}      # slot -> request
        self._waiting: list[_Request] = []
        self._uid = itertools.count()
        self._nonce = itertools.count(1)
        self._lock = threading.RLock()
        self._requests: dict[int, _Request] = {}
        self._prefixes: dict[int, tuple[KVCache, int]] = {}  # id -> (kv, p)
        self._prefix_uid = itertools.count()
        self._prefilling: dict[int, _Request] = {}  # slot -> chunking req
        # counters: dispatches of each step kind, admissions, tokens
        # recorded, and the latest requests' seconds from submit to token 0
        self.steps = {"decode": 0, "horizon": 0, "spec": 0}
        self.admissions = 0
        self.generated = 0
        self.first_token_s: collections.deque = collections.deque(maxlen=4096)
        # seconds in admissions (prefills whole or by chunk, each closed
        # by a device sync) and the prompt tokens they prefilled
        self.admission_s = 0.0
        self.prefill_tokens = 0

    def _new_cache(self, batch: int, length: int) -> KVCache:
        return KVCache.init(self._kv_cfg, batch, length, self.model.dtype,
                            self.device)

    def _timed(self, fn, *a):
        """fn(*a), its seconds to the end of its device work added to
        admission_s (the stream is shared: work that handler threads queued
        on it meanwhile counts too)."""
        t = time.perf_counter()
        out = fn(*a)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.admission_s += time.perf_counter() - t
        return out

    # -- device bodies (no host read: captured and replayed on the card) --
    def _ahead(self, nonces, counts, n: int):
        """([B, n] nonces, [B, n] counts + 0..n-1): the keys of n steps."""
        steps = torch.arange(n, device=counts.device)
        return nonces[:, None].expand(-1, n), counts[:, None] + steps

    def _decode_body(self, h: int, out: torch.Tensor):
        """`h` decode steps for every slot (JAX `_decode` / `_decode_multi`):
        step i writes each row at pos + i and samples with key
        (nonce, count + i), all h steps' Gumbels drawn first in one table;
        out [B, h] takes the tokens."""
        toks, pos, nonces, counts = self._state
        tok, mdl = toks, self.model
        g = self.noise.gumbel(*self._ahead(nonces, counts, h))    # [B, h, V]
        for i in range(h):
            logits, _ = mdl(mdl.embed(tok[:, None]), self.cache, pos + i)
            tok = _sample(logits[:, -1], self._temps, g[:, i])
            out[:, i].copy_(tok)

    def _spec_body(self, out: torch.Tensor):
        """One speculative round for all slots (JAX `_spec_round`): toks
        [B] are the pending tokens at pos [B]; counts the generated index
        of the first new token. out [B, k+2]: the committed tokens, then
        their count."""
        toks, pos, nonces, counts = self._state
        tgt, drf, k = self.model, self.draft, self.spec_k
        temps, nz = self._temps, self.noise
        # the proposals' Gumbels and the bonus' (key_for(k)), then the
        # acceptance uniforms and resample Gumbels of indices counts + i
        n_ahead, c_ahead = self._ahead(nonces, counts, k + 1)
        g = nz.gumbel(n_ahead, c_ahead)                      # [B, k+1, V]
        u = nz.uniform(n_ahead[:, :k], c_ahead[:, :k])       # [B, k]
        res = nz.resample(n_ahead[:, :k], c_ahead[:, :k])    # [B, k, V]
        tok, d_toks, d_dists = toks, [], []
        for i in range(k):
            lg, _ = drf(drf.embed(tok[:, None]), self.draft_cache, pos + i)
            dist = _token_dists(lg[:, -1], temps)
            tok = _sample_dist(dist, g[:, i])
            d_toks.append(tok)
            d_dists.append(dist)
        # catch-up feed, so that the draft's cache covers the whole block
        _feed(drf, drf.embed(tok[:, None]), self.draft_cache, pos + k, None)
        d_toks = torch.stack(d_toks, 1)                      # [B, k]
        d_dists = torch.stack(d_dists, 1)                    # [B, k, V]
        block = torch.cat([toks[:, None], d_toks], 1)        # [B, k+1]
        t_lg, _ = tgt(tgt.embed(block), self.cache, pos)
        t_dists = _token_dists(t_lg, temps)                  # [B, k+1, V]
        for b in range(self.slots):
            committed, n = accept_and_correct(d_toks[b], d_dists[b], t_dists[b],
                                              u[b], res[b], g[b, k])
            out[b, :k + 1].copy_(committed)
            out[b, k + 1].copy_(n)

    def _run(self, name: str) -> torch.Tensor:
        self.runners[name]()
        self.steps[name] += 1
        return self._outs[name]

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run each step function twice with every slot free, so that on
        the card each is captured before any request arrives (a capture
        while another thread launches work would fail). The writes land in
        free rows, which admission zeroes. Call it while the engine is
        idle."""
        if not self.graphs:
            return
        with self._lock:
            if self._active or self._prefilling:
                raise RuntimeError("DecodeEngine.warmup: the engine is busy")
            self._state.zero_()
            self._temps.zero_()
            for runner in self.runners.values():
                while runner.graph is None:
                    runner()

    # -- admission (eager, on the host's schedule) -------------------------
    def _first_token(self, logits, nonce: int, temp: float) -> int:
        """Token 0 from the last prompt row's logits [1, V], key (nonce, 0)."""
        dev = self.device
        t = torch.full((1,), temp, dtype=torch.float32, device=dev)
        g = self.noise.gumbel(torch.full((1,), nonce, dtype=torch.long, device=dev),
                              torch.zeros(1, dtype=torch.long, device=dev))
        return int(self._agree(_sample(logits, t, g))[0])

    def _fresh_row(self, cache: KVCache, slot: int) -> KVCache:
        row = cache.row(slot)
        for t in row.leaves():
            t.zero_()
        return row

    def _prefill(self, req: _Request, slot: int) -> int:
        s = req.embeds.shape[0]
        s_pad = -(-s // self.pad_to) * self.pad_to
        emb = _pad_rows(req.embeds, s_pad)[None]
        last = torch.tensor([s - 1], device=self.device)
        row = self._fresh_row(self.cache, slot)
        if req.prefix_id is not None:
            kv, p = self._prefixes[req.prefix_id]
            p_pad = kv.k.shape[2]
            for r, t in zip(row.leaves(), kv.leaves()):
                r[:, :, :p_pad].copy_(t)
            start = torch.tensor(p, device=self.device)
            req.prompt_len = p + s
        else:
            start, req.prompt_len = 0, s
        logits, _ = self.model(emb, row, start, logits_at=last)
        if self.draft is not None:
            _feed(self.draft, emb, self._fresh_row(self.draft_cache, slot), 0, None)
        return self._first_token(logits[:, 0], req.nonce, req.temperature)

    def register_prefix(self, prefix_embeds) -> int:
        """Prefill a shared prompt prefix [P, D] once and keep its KV block
        ([L, 1, P_pad, ...] per cache tensor: P_pad positions of memory,
        not a slot). Returns the id for submit(prefix_id=)."""
        self._owner("register_prefix")
        emb = self._to_device(prefix_embeds)
        with torch.inference_mode(), self._lock:
            self._plan(_PREFIX, emb.shape[0], emb=emb)
            return self._register(emb)

    def _register(self, emb) -> int:
        p = emb.shape[0]
        p_pad = -(-p // self.pad_to) * self.pad_to
        kv = self._new_cache(1, p_pad)
        _feed(self.model, _pad_rows(emb, p_pad)[None], kv, 0, None)
        pid = next(self._prefix_uid)
        self._prefixes[pid] = (kv, p)
        return pid

    def drop_prefix(self, prefix_id: int) -> None:
        """Release a registered prefix's KV block."""
        self._owner("drop_prefix")
        with self._lock:
            self._plan(_DROP, prefix_id)
            self._prefixes.pop(prefix_id, None)

    def _to_device(self, embeds) -> torch.Tensor:
        if not isinstance(embeds, torch.Tensor):
            embeds = torch.from_numpy(np.array(embeds))
        return embeds.to(self.device, self.model.dtype)

    def submit(self, input_embeds, cfg: GenerateConfig | None = None,
               prefix_id: int | None = None) -> int:
        """Queue one spliced prompt [S, D]; returns a request uid. It starts
        decoding when a slot frees up. With prefix_id, input_embeds is the
        suffix after the registered prefix."""
        self._owner("submit")
        cfg = cfg or GenerateConfig()
        s = input_embeds.shape[0]
        s_pad = -(-s // self.pad_to) * self.pad_to
        # a speculative round writes up to k+1 positions past the frontier
        spec_pad = (self.spec_k + 1) if self.draft is not None else 0
        if prefix_id is not None:
            if self.draft is not None:
                raise ValueError("speculative decoding does not compose "
                                 "with prefix caching")
            kv, p = self._prefixes[prefix_id]
            p_pad = kv.k.shape[2]
            # suffix KV lands at p..p+s_pad; everything must fit the slot
            if max(p_pad, p + s_pad, p + s + cfg.max_new_tokens) > self.max_len:
                raise ValueError(
                    f"prefix {p} + suffix {s} (padded {s_pad}) + max_new "
                    f"{cfg.max_new_tokens} exceeds the engine max_len "
                    f"{self.max_len}")
        # the prefill writes the padded prompt into the slot row, so the
        # bucket itself must fit the cache too
        elif max(s_pad, s + cfg.max_new_tokens + spec_pad) > self.max_len:
            margin = (f" + speculative margin {spec_pad}" if spec_pad
                      else "")
            raise ValueError(
                f"prompt {s} (padded {s_pad}) + max_new "
                f"{cfg.max_new_tokens}{margin} exceeds the engine max_len "
                f"{self.max_len}")
        req = _Request(uid=next(self._uid),
                       embeds=self._to_device(input_embeds),
                       max_new_tokens=cfg.max_new_tokens,
                       temperature=(cfg.temperature if cfg.do_sample
                                    else 0.0),
                       eot_ids=tuple(int(e) for e in cfg.eot_ids),
                       nonce=next(self._nonce), prefix_id=prefix_id,
                       t_submit=time.perf_counter())
        with self._lock:
            self._waiting.append(req)
            self._requests[req.uid] = req
        return req.uid

    # -- scheduling --------------------------------------------------------
    def _admit(self):
        while self._free and self._waiting:
            req = self._waiting.pop(0)
            slot = self._free.pop(0)
            self._plan(_ADMIT, req.uid, slot, req.nonce, req.temperature,
                       req.embeds.shape[0],
                       -1 if req.prefix_id is None else req.prefix_id,
                       req.max_new_tokens, len(req.eot_ids), *req.eot_ids,
                       emb=req.embeds)
            self._admit_one(req, slot)

    def _admit_one(self, req: _Request, slot: int):
        """Prefill `req` into `slot` (whole, or set up its chunked
        prefill) and record token 0."""
        self.admissions += 1
        s = req.embeds.shape[0]
        self.prefill_tokens += s
        c = self.prefill_chunk
        if c and s > c:
            pkv, p = ((None, 0) if req.prefix_id is None
                      else self._prefixes[req.prefix_id])
            n = -(-s // c)
            if p + n * c <= self.max_len:
                row = self._new_cache(1, self.max_len)
                if pkv is not None:
                    for r, t in zip(row.leaves(), pkv.leaves()):
                        r[:, :, :t.shape[2]].copy_(t)
                req.row = row
                req.chunk_emb = _pad_rows(req.embeds, n * c)
                req.base_off, req.chunk_i, req.n_chunks = p, 0, n
                req.slot = slot
                self._prefilling[slot] = req
                return
        tok = self._timed(self._prefill, req, slot)
        req.slot = slot
        self._active[slot] = req
        self._record(req, tok)

    def _record(self, req: _Request, tok: int):
        # EOT is never appended (an append-then-pop would let a concurrent
        # streaming reader observe a frame holding the stop token whose
        # successor frame then shrinks)
        if req.t_first is None:
            req.t_first = time.perf_counter()
            self.first_token_s.append(req.t_first - req.t_submit)
        is_eot = tok in req.eot_ids
        if not is_eot:
            req.out_ids.append(tok)
            self.generated += 1
        if (is_eot or len(req.out_ids) >= req.max_new_tokens
                or req.prompt_len + len(req.out_ids) >= self.max_len):
            req.done = True
            # the prompt embeddings (MBs of spliced image features) and a
            # chunked prefill's row are dead weight once decoding ends
            req.embeds = None
            req.chunk_emb = None
            req.row = None
            self._active.pop(req.slot, None)
            self._free.append(req.slot)
            req.event.set()

    def _advance_prefills(self):
        """One chunk for every chunk-prefilling slot. Co-tenant steps write
        garbage into such a slot's pool row; the finished row replaces it
        whole."""
        c = self.prefill_chunk
        for slot, req in list(self._prefilling.items()):
            off = torch.tensor(req.base_off + req.chunk_i * c, device=self.device)
            chunk = req.chunk_emb[req.chunk_i * c:(req.chunk_i + 1) * c][None]
            req.chunk_i += 1
            if req.chunk_i < req.n_chunks:
                _feed(self.model, chunk, req.row, off, None)
                continue
            s = req.embeds.shape[0]
            idx = torch.tensor([(s - 1) - (req.n_chunks - 1) * c],
                               device=self.device)
            logits, _ = self.model(chunk, req.row, off, logits_at=idx)
            for pool, r in zip(self.cache.row(slot).leaves(), req.row.leaves()):
                pool.copy_(r)
            tok = self._first_token(logits[:, 0], req.nonce, req.temperature)
            req.row = req.chunk_emb = None
            del self._prefilling[slot]
            req.prompt_len = req.base_off + s
            self._active[slot] = req
            self._record(req, tok)

    def _use_horizon(self) -> bool:
        """Multi-step only when the scheduler would otherwise idle between
        steps: nothing waiting for a slot, no chunked prefill needing its
        per-step cadence, and some row with a full horizon of tokens left."""
        if (self.decode_horizon <= 1 or self._waiting or self._prefilling
                or self.draft is not None):
            return False
        return any(
            min(req.max_new_tokens,
                self.max_len - req.prompt_len) - len(req.out_ids)
            >= self.decode_horizon for req in self._active.values())

    @torch.inference_mode()
    def step(self) -> int:
        """Admit waiting requests, advance chunked prefills by one chunk,
        then advance every active slot (one token, a horizon, or a
        speculative round). Returns the number of unfinished requests."""
        self._owner("step")
        with self._lock:
            self._admit()
            if self._prefilling:
                self._plan(_CHUNKS)
                self._timed(self._advance_prefills)
            if not self._active:
                return len(self._prefilling) + len(self._waiting)
            kind = (_SPEC if self.draft is not None
                    else _HORIZON if self._use_horizon() else _DECODE)
            self._plan(_STEP, kind)
            self._advance_active(kind)
            return (len(self._active) + len(self._prefilling)
                    + len(self._waiting))

    def _advance_active(self, kind: int):
        """One decode step, horizon or speculative round for the active
        slots, and its tokens recorded."""
        state = np.zeros((4, self.slots), np.int64)
        temps = np.zeros((self.slots,), np.float32)
        for slot, req in self._active.items():
            # the incoming token out_ids[-1] goes at the position after
            # the prompt and the previously written generations
            state[:, slot] = (req.out_ids[-1],
                              req.prompt_len + len(req.out_ids) - 1,
                              req.nonce, len(req.out_ids))
            temps[slot] = req.temperature
        self._state.copy_(torch.from_numpy(state))
        self._temps.copy_(torch.from_numpy(temps))
        if kind == _SPEC:
            res = self._agree(self._spec_round()).cpu().numpy()
            k = self.spec_k
            for slot, req in list(self._active.items()):
                for t in res[slot, :int(res[slot, k + 1])]:
                    self._record(req, int(t))
                    if req.done:
                        break   # drop the rest of the block
            return
        burst = self._agree(self._decode_multi() if kind == _HORIZON
                            else self._decode()).cpu().numpy()
        for slot, req in list(self._active.items()):
            for t in burst[slot]:
                self._record(req, int(t))
                if req.done:
                    break   # trim the burst at the stop

    # -- tensor parallelism: rank 0 plans, the other ranks follow ---------
    def _owner(self, what: str):
        if self._rank:
            raise RuntimeError(f"DecodeEngine.{what}: rank 0 of the mesh owns "
                               "the queue; this rank runs follow()")

    def _plan(self, op: int, *vals, emb=None):
        """Rank 0: one plan entry (op and up to 15 numbers, then the
        embeddings [S, D] of an admission or a prefix) to the other ranks
        of the group; nothing without a group."""
        if self._group is None:
            return
        if len(vals) >= _PLAN_LEN:
            raise ValueError("DecodeEngine: a plan entry holds at most "
                             f"{_PLAN_LEN - 1} numbers")
        head = torch.zeros(_PLAN_LEN, dtype=torch.float64)
        head[:len(vals) + 1] = torch.tensor([op, *vals], dtype=torch.float64)
        broadcast(head.to(self.device), self._group, 0)
        if emb is not None:
            broadcast(emb.contiguous(), self._group, 0)

    def _receive(self) -> list:
        head = torch.zeros(_PLAN_LEN, dtype=torch.float64, device=self.device)
        return broadcast(head, self._group, 0).cpu().tolist()

    def _receive_embeds(self, s: int) -> torch.Tensor:
        emb = torch.empty((s, self.model.cfg.dim), dtype=self.model.dtype,
                          device=self.device)
        return broadcast(emb, self._group, 0)

    def _agree(self, toks: torch.Tensor) -> torch.Tensor:
        """Rank 0's tokens on every rank of the group (in place); a rank
        whose own differ adds one to `disagreements`."""
        if self._group is None:
            return toks
        mine = toks.clone()
        broadcast(toks, self._group, 0)
        self.disagreements += int(bool((mine != toks).any()))
        return toks

    def stop_followers(self) -> None:
        """Rank 0: end the other ranks' follow() (call once, when done)."""
        self._owner("stop_followers")
        with self._lock:
            self._plan(_STOP)

    @torch.inference_mode()
    def follow(self) -> None:
        """The other ranks' side of a tensor-parallel engine: run rank 0's
        plan entries (the same admissions, chunks, steps and prefixes, on
        this rank's shards) until rank 0 calls stop_followers(). The
        requests' streams are then rank 0's, by uid (`result`)."""
        if self._group is None or self._rank == 0:
            raise RuntimeError("DecodeEngine.follow: only the ranks other "
                               "than 0 of a tensor-parallel engine follow")
        while True:
            head = self._receive()
            op = int(head[0])
            if op == _STOP:
                return
            with self._lock:
                if op == _ADMIT:
                    uid, slot, nonce, temp, s, pid, max_new, n_eot = head[1:9]
                    eot = tuple(int(e) for e in head[9:9 + int(n_eot)])
                    req = _Request(uid=int(uid),
                                   embeds=self._receive_embeds(int(s)),
                                   max_new_tokens=int(max_new),
                                   temperature=temp, eot_ids=eot,
                                   nonce=int(nonce),
                                   prefix_id=None if pid < 0 else int(pid),
                                   t_submit=time.perf_counter())
                    self._requests[req.uid] = req
                    self._free.remove(int(slot))
                    self._admit_one(req, int(slot))
                elif op == _CHUNKS:
                    self._timed(self._advance_prefills)
                elif op == _STEP:
                    self._advance_active(int(head[1]))
                elif op == _PREFIX:
                    self._register(self._receive_embeds(int(head[1])))
                elif op == _DROP:
                    self._prefixes.pop(int(head[1]), None)
                elif op == _FAIL:
                    self._fail_local("failed on rank 0")
                else:
                    raise RuntimeError(f"DecodeEngine.follow: plan op {op}")

    # -- results -----------------------------------------------------------
    def result(self, uid: int) -> np.ndarray:
        req = self._requests[uid]
        if req.error is not None:
            raise RuntimeError(f"request {uid} failed: {req.error}")
        if not req.done:
            raise RuntimeError(f"request {uid} not finished")
        return np.asarray(req.out_ids, np.int32)

    def wait(self, uid: int, timeout: float | None = None) -> np.ndarray:
        """Block until `uid` finishes (another thread must drive step())."""
        req = self._requests[uid]
        if not req.event.wait(timeout):
            raise TimeoutError(f"request {uid}")
        return self.result(uid)

    def release(self, uid: int) -> None:
        """Forget a finished (or abandoned) request: a long-running worker
        calls this after reading the result. Decoding of a still-active
        uid continues; only the uid's index entry goes."""
        with self._lock:
            self._requests.pop(uid, None)

    def fail_all(self, msg: str) -> None:
        """Fail every in-flight request (the stepping thread's recovery): wake
        all waiters with `msg`, free the slots, drop queued work. The pool
        stays as it is: a freed slot is zeroed on reuse."""
        with self._lock:
            if not self._rank:
                self._plan(_FAIL)
            self._fail_local(msg)

    def _fail_local(self, msg: str) -> None:
        inflight = (list(self._active.values())
                    + list(self._prefilling.values()) + list(self._waiting))
        self._active.clear()
        self._prefilling.clear()
        self._waiting.clear()
        self._free = list(range(self.slots))
        for req in inflight:
            req.error = msg
            req.done = True
            req.embeds = req.chunk_emb = req.row = None
            req.event.set()

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        """Drive step() until every submitted request has finished."""
        for _ in range(max_steps):
            if self.step() == 0 and not self._waiting:
                return
        raise RuntimeError("engine did not drain")

    def generate_all(self, prompts: Sequence, cfg: GenerateConfig
                     ) -> list[np.ndarray]:
        """Submit [S, D] prompts, drain, return the ids in submission
        order."""
        uids = [self.submit(p, cfg) for p in prompts]
        self.run_until_idle()
        return [self.result(u) for u in uids]
