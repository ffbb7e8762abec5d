#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rsvldm_tpu_torch).

    python3 chip_smoke.py            # every phase, one NVIDIA GPU (sm_90a)

Phases, each printed on its own line:
  1. device    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build     K1 (csrc/flash_fwd.cu), the fused backward and its prologue
               (csrc/flash_bwd.cu) and K2 (csrc/int4_decode.cu) with nvcc
               for sm_90a, one nvcc per source, started together
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and a few edge cases (K2 also on
               rounding ties, zero rows, and one device kernel per call
               under torch.profiler); kernel, plain and library times (K1,
               the backward, K2 and their yardsticks by CUDA-graph replay:
               device time), the least time the card could take, and K2's
               sum per decode step; folder mode's shapes too: K1 at the
               batched prefill (B=8 S=1408 H=32 D=128 causal) and the
               batched refinement (B=8 S=4096 H=10, B=8 S=1024 H=20, D=64),
               K2 at 8 rows on the five decode shapes and its sum per
               decode step at 8 rows; and the speculative verify forward's:
               K2 at 5 rows (spec_k + 1) on the five shapes, its sum per
               verify step
  4. reference process() at a small width on the card (bf16, K1 in use)
               against the same run in fp32 on the CPU: same weights, same
               noise, PNGs within a stated uint8 tolerance; then a
               small-width caption, int4 and int8, card against CPU: same
               quantized weights and prompt, prefill + 8 decode steps
               teacher-forced with the CPU's tokens, logit cosine and top-1
               agreement per step (K1 and K2 in use), and the activation
               quantizers' codes and scales card against CPU, bit for bit;
               then one QLoRA loss
               and its adapter gradients at a small width with 128-wide
               heads and 1024 tokens, int8 and int4, card (bf16, remat: K1
               and the backward) against CPU (fp32): loss and per-leaf
               gradient cosine. In this phase too, the loops' step functions
               (utils/graphs.StepRunner) replayed as CUDA graphs against
               direct calls on the same inputs: SR3 and DDIM (8 steps),
               RestoreEDM on a 64^2 latent (a mixed run, all misses, all
               hits: the same DFB trace), the caption decode (40 tokens:
               the same ids and K2 launches); and the batched caption
               (three images of different shapes, ragged prompts, one
               batched prefill with the lm_head on each row's last
               position, 8 decode steps of all rows teacher-forced) card
               against CPU, per row; speculative decoding on the card
               (int4, a one-layer self-draft, k = 4, 40 greedy tokens): the
               ids of greedy `generate`, every round after the first
               replayed, K2 launches as the formula; and process() with
               the tiled VAE (three downsamples, 48-pixel encoder and
               10-latent decoder tiles, overlapping) card against CPU
  5. path      the full-width modules (SR3 64-ch; SDXL XL-base + GLVControl,
               the SDXL VAE with its twin encoder, CLIP-L, bigG; LLaVA-NeXT-8B:
               CLIP-L/336 + mlp2x_gelu + Llama-3-8B, dense) with seeded bf16
               weights, written as the reference checkpoint directory (SR3's
               .pth, the juggernaut safetensors, SR-v0Q.ckpt, four LLaVA
               safetensors shards with a Llama-3-style tokenizer.json, a
               Llava-next PEFT adapter, clip_vocab) in a temporary directory
               with room for it; the pipeline built from that directory
               alone by the CLI's construction (infer.build_pipeline,
               --quant int4), every family's weights checked against the
               written bytes and the adapted projections against the fp32
               merge, the prompt's token ids against the assets' own; then
               SuperResolutionPipeline.process() (256 new tokens sampled at
               T=0.2, a seeded 28x28 input: 224^2 Stage 1, 1024^2 (128^2
               latent) Stage 2b) with every loop replaying CUDA graphs
               (each graph's capture seconds, peak memory); graph replay
               against direct calls at full width (16 decode steps, 10 SR3
               steps, denoiser miss steps and hit steps); Stage 1 as DDIM
               in 50 steps, timed; the kernel launches of one decode step
               without and with a train_vlm LoRA archive attached; write,
               load (per family, the LLaVA's split into read, PEFT merge and
               quantize) and read-rate figures;
     spec      on the path's int4 captioner and Stage-1 image: the
               256-token caption at T=0.2 vanilla, with the self-draft of
               4 layers (k = 4) and with a seeded 2-layer draft checkpoint
               (hidden 4096, vocab 128256) written to <dir>/llava_draft and
               read through infer.build_pipeline --draft_dir: seconds,
               decode tok/s, rounds, accept_rate, ms a round by graph
               replay, capture seconds, K2 launches a round (must be
               k (7n + 1) + 7n + 225 for a draft of n layers, every round
               after the first replayed); then the same greedy: the prefix
               on which speculative and vanilla ids agree, and the target's
               top-2 logit gap where they part (reported)
     tiled     on the path's pipeline: the 1024^2 refinement with and
               without use_tile_vae (512 / 64 tiles: 4 encoder tiles of
               576^2, 4 decoder tiles of 86^2 latent): vae_prep and decode
               seconds, peak memory, the VAE alone each way, the uint8
               difference between the images (reported); the tiled VAE
               alone at 2048^2 (16 tiles each), and the reckoned bytes of
               the whole VAE's 65536^2 mid-attention scores there;
               the directory is deleted after phase folder;
               then the train_vlm loop at full width: the same geometry
               with an int8 decoder, LoRA r=16 on the seven projections,
               AdamW, gradient checkpointing, 16 anyres 224^2 records,
               4 steps of batch 4 padded to 1536 tokens. Each path's kernel
               launch counts are reset just before it and read just after.
     folder    (before the directory is deleted, and after the path's
               pipeline is freed) folder mode as a user runs it: the
               processor built by infer_dir.build_processor (--quant int4)
               from that directory, ImageBatchProcessor.run() over 8 seeded
               LR tiles (seven 28^2, one 32^2: Stage-1 groups of 7 and 1;
               one batched int4 caption of 8, 256 tokens at T=0.2; two
               batched 1024^2 refinements of 4, the second replaying the
               kept graphs of the first): every status ok, no fallback, 16
               PNGs, K1 / K2 launches as the batches ran (reported under
               `folder`), seconds per stage and per image, prefill and
               decode rates, DFB hits and capture seconds per chunk, peak
               memory with the loops kept; then graph replay against direct
               calls at this width (16 decode steps at B=8: ids and K2
               launches; 10 SR3 steps at batch 7)
  6. profile   (--profile) one int4 decode step, one SR3 step, one
               cache-miss and one cache-hit denoising step, each replayed
               from a CUDA graph, a decode step at 8 rows (folder), and the
               last training step, under torch.profiler: device time by
               kernel, the bf16 -> fp32 copies' share, idle share
The line before the last is the kernel report as one JSON object; the last
line is {"ok": true, "device": {...}}, printed only when every phase passed.
Exits non-zero, with no result, when there is no CUDA card or the port's
package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, H100 SXM data sheet

REPO = Path(__file__).resolve().parent
SEED = 0  # weights, input image and noise are all made from it
# bf16 on the card against fp32 on the CPU, through 8 SR3 and 4 EDM steps
# of random-weight networks: an H100 gave 0.62 mean / 3 max uint8 levels on
# the final PNG (0.08 / 1 after Stage 1); the limits leave 2.4x / 4x margin
REF_MEAN_TOL, REF_MAX_TOL = 1.5, 12
# K1 against its plain version, both in bf16 on the card. Per element
# |err| <= ATOL + RTOL*|ref|, and over the whole output
# rms(err) <= RMS_TOL*rms(ref). At sdxl_s4096 the outputs are small (rms about
# 0.026), so ATOL is a few bf16 ulps of the largest of them; a kernel that
# skipped one of the 64 K/V tiles there would be off by about 0.1*rms(ref).
K1_ATOL, K1_RTOL, K1_RMS_TOL = 4e-3, 2e-2, 1e-2
K1_LSE_TOL = 1e-4  # lse is fp32 on both sides
# The backward (bf16 inputs, p and ds rounded to bf16 before their
# products, fp32 sums; dq summed by reduce-adds in a changing order) against
# its plain version in fp32 on the same inputs, per gradient: per element
# |err| <= K34_ATOL*rms(ref) + K34_RTOL*|ref|, and rms(err) <=
# K34_RMS_TOL*rms(ref). An H100 gave rms(err)/rms(ref) 0.0023-0.0024 for
# dq, dk and dv at every shape with the two-kernel version (K3, K4), and
# per element at most 0.57 of the limit; RMS_TOL leaves 2.5x margin.
K34_ATOL, K34_RTOL, K34_RMS_TOL = 0.1, 0.05, 0.006
# K1 sites per denoising step of the full-width XL-base UNet + GLVControl:
# 34 in GLVControl, 24 in the UNet input blocks, 48 in `rest`. A cache hit
# runs GLVControl and the input blocks only. The Llama-3-8B prefill (about
# 1280 tokens) adds one per layer.
K1_PER_MISS, K1_PER_HIT, K1_PER_CAPTION = 106, 58, 32
# K2's decode-step shapes (R = 1: name, in, out) and launches a step: q, o;
# k, v; gate, up; down in each of 32 layers; the lm_head once (225 in all)
K2_STEP = (("q_o_proj", 4096, 4096, 64), ("k_v_proj", 4096, 1024, 64),
           ("gate_up_proj", 4096, 14336, 64), ("down_proj", 14336, 4096, 32),
           ("lm_head", 4096, 128256, 1))
K2_PER_STEP = sum(n for *_, n in K2_STEP)
# speculative caption decoding (phase spec): proposals a round, the
# self-draft's depth, the draft checkpoint's depth; K2 launches a round
# with a draft of n int4 layers: k draft steps (7n projections and the
# lm_head each), the catch-up feed (7n, no lm_head), the verify forward
# (225 at k + 1 rows)
SPEC_K, SELF_DRAFT_LAYERS, DRAFT_LAYERS = 4, 4, 2


def k2_per_round(n: int, k: int = SPEC_K, layers: int = 32) -> int:
    return k * (7 * n + 1) + 7 * n + 7 * layers + 1
# K2 against its plain version, both fp32 sums of exact int32 group sums
# that differ only in order: per element |err| <= K2_RTOL * sum_g |term_g|
# + K2_ATOL, where term_g = xs*ws*acc of group g (the fp32 rounding bound of
# up to 112 terms summed in two orders is about 1.3e-5 of that sum). An
# H100 gave |err| <= 1.6e-6, at most 0.03 of this limit, at the decode
# shapes; a K2 that drops one contraction split exceeds it 11000-93000
# times, one that rounds half away from zero 850 times on the ties case.
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# Caption reference, bf16 on the card against fp32 on the CPU, teacher-
# forced: per step, the cosine of the two logit vectors and whether their
# argmaxes agree. With the same quantized bytes on both sides an H100 gave
# cosines 0.99974-0.99981 (int4) and 0.99965-0.99971 (int8), argmaxes equal
# at 9/9 and 7/9 positions (random weights leave near-ties among 128256
# logits); a K2 that drops one contraction split gives 0.35. The limits
# leave about 6x margin on 1 - cos and allow four flips in nine.
CAP_COS_MIN, CAP_TOP1_MIN = 0.998, 0.5
# Train reference, bf16 on the card (remat, K1 and the backward) against
# fp32 on the CPU: the loss's relative error and the cosine of each adapter
# leaf's gradient. An H100 gave 1.4e-4 / 1.0e-4 (int8 / int4) and a smallest
# cosine of 0.99925 / 0.99938 over the 28 leaves; the limits leave about
# 14x and 6x margin (on 1 - cos).
TRAIN_LOSS_RTOL, TRAIN_COS_MIN = 2e-3, 0.995
# Graph replay against direct calls of the same step functions on the card
# (utils/graphs.StepRunner): the same kernels on the same inputs, so the
# latents are expected bit-equal; the limit, max |graph - direct| <=
# GRAPH_TOL * max(1, max |direct|), leaves room only for a library picking
# another algorithm under capture. Caption ids and DFB traces must be equal.
GRAPH_TOL = 1e-3
LLAMA3_SPECIAL = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                  "<|end_header_id|>": 128007, "<|eot_id|>": 128009}


class StandInTokenizer:
    """Llama-3 special-token strings to their ids, every other
    whitespace-separated word to a crc32 bucket below them, so a prompt has
    about its BPE length. decode writes bucket ids as words."""

    _split = re.compile("(" + "|".join(map(re.escape, LLAMA3_SPECIAL)) + ")")

    def encode(self, text, add_special_tokens=False):
        ids = []
        for part in self._split.split(text):
            if part in LLAMA3_SPECIAL:
                ids.append(LLAMA3_SPECIAL[part])
            else:
                ids += [zlib.crc32(w.encode()) % 128000 for w in part.split()]
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i < 128000)


# ------------------------------------------------- the checkpoint directory
# The tokenizer assets and the safetensors writer below make the reference
# checkpoint layout that phase `path` reads; the tests use the same helpers
# with the `tokenizers` and `transformers` packages as oracles.

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# the same split in the stdlib `re` for text without "_" and without letters
# or digits outside \w (the texts the assets are learnt from)
_HELPER_SPLIT = re.compile(r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\w]?[^\W\d_]+|"
                           r"\d{1,3}| ?[^\s\w]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CLIP_SPLIT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"
                         r"'ll|'d|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE)


def _byte_chars():
    """GPT-2's byte -> printable char map."""
    bs = (list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _learn_bpe(words: dict, n_merges: int):
    """Byte-pair merges learnt from {symbol tuple: count}: the most frequent
    adjacent pair first (ties: the smallest pair), never a pair whose join is
    already a token. Returns (merges, {word: its final symbols})."""
    import heapq
    seqs = [list(w) for w in words]
    freq = list(words.values())
    count, where = {}, {}
    for i, sq in enumerate(seqs):
        for p in zip(sq, sq[1:]):
            count[p] = count.get(p, 0) + freq[i]
            where.setdefault(p, set()).add(i)
    tokens = {c for sq in seqs for c in sq}
    heap = [(-c, p) for p, c in count.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n_merges:
        c, p = heapq.heappop(heap)
        if count.get(p, 0) != -c or c == 0:
            continue
        joined = p[0] + p[1]
        if joined in tokens:
            count[p] = 0
            continue
        merges.append(p)
        tokens.add(joined)
        changed = set()
        for i in where.pop(p, ()):
            sq = seqs[i]
            for q in zip(sq, sq[1:]):
                count[q] -= freq[i]
                changed.add(q)
            out, j = [], 0
            while j < len(sq):
                if j + 1 < len(sq) and (sq[j], sq[j + 1]) == p:
                    out.append(joined)
                    j += 2
                else:
                    out.append(sq[j])
                    j += 1
            seqs[i] = out
            for q in zip(out, out[1:]):
                count[q] = count.get(q, 0) + freq[i]
                where.setdefault(q, set()).add(i)
                changed.add(q)
        for q in changed:
            if count[q] > 0:
                heapq.heappush(heap, (-count[q], q))
    return merges, {w: tuple(sq) for w, sq in zip(words, seqs)}


def _seeded_words(seed: int, n: int):
    """n seeded lower-case words, letters drawn by English frequency."""
    import random
    rnd = random.Random(seed)
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    weights = [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8,
               2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15,
               0.1, 0.07]
    return ["".join(rnd.choices(letters, weights, k=rnd.randint(2, 9)))
            for _ in range(n)]


class Llama3Assets:
    """A Llama-3-style tokenizer.json (tokenizers' format): the Split
    pre-tokenizer with Llama-3's pattern, ByteLevel, a BPE of the 256 byte
    tokens and merges learnt from a seeded word list and `texts`, with
    ignore_merges, filler tokens up to `special_start`, `n_special` special
    tokens from there (<|begin_of_text|>, <|start_header_id|>,
    <|end_header_id|> and <|eot_id|> at Llama-3's offsets 0, 6, 7, 9), and
    the BOS template. `encode` is the assets' own encoding of the texts
    they were learnt from (the whole piece when it is a token, else its
    learnt segmentation); it refuses other text."""

    NAMED = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
             6: "<|start_header_id|>", 7: "<|end_header_id|>", 9: "<|eot_id|>"}

    def __init__(self, texts, n_merges: int = 3000, seed: int = SEED,
                 special_start: int = 128000, n_special: int = 256):
        bc = _byte_chars()
        self.specials, k = {}, 0
        for i in range(n_special):
            name = self.NAMED.get(i)
            if name is None:
                name, k = f"<|reserved_special_token_{k}|>", k + 1
            self.specials[name] = special_start + i
        self._special_re = re.compile("|".join(map(re.escape, self.specials)))
        corpus = " ".join(_seeded_words(seed, 4000))
        words: dict = {}
        for text in [corpus, *texts]:
            for chunk in self._special_re.split(text):
                for piece in _HELPER_SPLIT.findall(chunk):
                    w = tuple(bc[b] for b in piece.encode())
                    words[w] = words.get(w, 0) + 1
        merges, self._learnt = _learn_bpe(words, n_merges)
        vocab = {bc[b]: i for i, b in enumerate(sorted(bc))}
        for a, b in merges:
            vocab[a + b] = len(vocab)
        if len(vocab) > special_start:
            raise ValueError(f"{len(vocab)} tokens do not fit below {special_start}")
        i = 0
        while len(vocab) < special_start:  # never a whole piece: " w" + digits
            vocab[f"Ġw{i}"] = len(vocab)
            i += 1
        self.vocab, self.merges = vocab, merges
        self._bc = bc
        bos = self.NAMED[0]
        self.spec = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False,
                              "normalized": False, "special": True}
                             for t, i in self.specials.items()],
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "trim_offsets": True, "use_regex": False}]},
            "post_processor": {"type": "Sequence", "processors": [
                {"type": "ByteLevel", "add_prefix_space": True,
                 "trim_offsets": False, "use_regex": True},
                {"type": "TemplateProcessing",
                 "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                            {"Sequence": {"id": "A", "type_id": 0}}],
                 "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                          {"Sequence": {"id": "A", "type_id": 0}},
                          {"SpecialToken": {"id": bos, "type_id": 1}},
                          {"Sequence": {"id": "B", "type_id": 1}}],
                 "special_tokens": {bos: {"id": bos, "ids": [self.specials[bos]],
                                          "tokens": [bos]}}}]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                        "trim_offsets": True, "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": False,
                      "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}

    def write(self, d: Path):
        d.mkdir(parents=True, exist_ok=True)
        (d / "tokenizer.json").write_text(json.dumps(self.spec, ensure_ascii=False))
        (d / "tokenizer_config.json").write_text(json.dumps({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
            "clean_up_tokenization_spaces": True,
            "model_max_length": 1000000}))

    def encode(self, text: str):
        ids, pos = [], 0
        for m in [*self._special_re.finditer(text), None]:
            chunk = text[pos:m.start() if m else len(text)]
            for piece in _HELPER_SPLIT.findall(chunk):
                w = tuple(self._bc[b] for b in piece.encode())
                if "".join(w) in self.vocab:
                    ids.append(self.vocab["".join(w)])
                else:
                    ids += [self.vocab[t] for t in self._learnt[w]]
            if m:
                ids.append(self.specials[m.group()])
                pos = m.end()
        return ids


class ClipAssets:
    """CLIP BPE assets in HF's format (vocab.json, merges.txt): the 256 byte
    tokens and their word-final forms, merges learnt from a seeded word
    list and `texts` (lower-cased, split as CLIP splits), and
    <|startoftext|> / <|endoftext|> at `sot` / `sot + 1`. `encode` is the
    assets' own encoding of the texts they were learnt from."""

    def __init__(self, texts, n_merges: int = 3000, seed: int = SEED,
                 sot: int = 49406):
        bc = _byte_chars()
        words: dict = {}
        for text in [" ".join(_seeded_words(seed + 1, 4000)), *texts]:
            for w in self._words(text, bc):
                words[w] = words.get(w, 0) + 1
        base = [bc[b] for b in sorted(bc)]
        vocab = {t: i for i, t in enumerate(base + [t + "</w>" for t in base])}
        merges, self._learnt = _learn_bpe(words, min(n_merges, sot - len(vocab)))
        for a, b in merges:
            vocab[a + b] = len(vocab)
        vocab["<|startoftext|>"], vocab["<|endoftext|>"] = sot, sot + 1
        self.vocab, self.merges, self._bc = vocab, merges, bc

    @staticmethod
    def _words(text, bc):
        text = re.sub(r"\s+", " ", text).strip().lower()
        for piece in _CLIP_SPLIT.findall(text):
            w = [bc[b] for b in piece.encode()]
            yield tuple(w[:-1]) + (w[-1] + "</w>",)

    def write(self, d: Path):
        d.mkdir(parents=True, exist_ok=True)
        (d / "vocab.json").write_text(json.dumps(self.vocab, ensure_ascii=False))
        (d / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in self.merges))

    def encode(self, text: str):
        """[SOT] + the text's ids + [EOT]."""
        ids = [self.vocab[t] for w in self._words(text, self._bc)
               for t in self._learnt[w]]
        return [self.vocab["<|startoftext|>"], *ids, self.vocab["<|endoftext|>"]]


SAFETENSORS_DTYPES = {"float64": "F64", "float32": "F32", "float16": "F16",
                      "bfloat16": "BF16", "int64": "I64", "int32": "I32",
                      "int16": "I16", "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(path: Path, tensors, metadata=None) -> int:
    """Writes {name: tensor} (on any device) in the safetensors format, one
    tensor at a time through the host; returns the bytes written."""
    import torch
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().cpu().contiguous().reshape(-1)
                        .view(torch.uint8).numpy().tobytes())
    return 8 + len(head) + offset


def _say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw, sort_keys=True), flush=True)


def _graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph (on `stream`, when given) and replayed, so host-side launch costs
    drop out."""
    import torch
    with torch.cuda.stream(stream):  # a None stream leaves the current one
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    _say("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    return line


# --------------------------------------------------------------- phase 2
def phase_build():
    from rsvldm_tpu_torch.ops import flash_attention, quant
    from rsvldm_tpu_torch.utils import cuda_build

    def build(source):
        t0 = time.perf_counter()
        log = cuda_build.build(source)
        return source, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE, quant.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        done = list(pool.map(build, sources))
    for source, log, seconds in done:
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        _say("build", source=source, ptxas=ptxas, seconds=round(seconds, 3))
    _say("build", all_seconds=round(time.perf_counter() - t0, 3))


# --------------------------------------------------------------- phase 3
def _valid_pairs(sq, sk, kv_len, causal):
    if not causal:
        return sq * kv_len
    off = kv_len - sq
    return sum(min(max(r + off + 1, 0), kv_len) for r in range(sq))


def _flash_case(name, b, sq, sk, h, d, *, causal=False, kv_len=None,
                lse=False, timed=False, main_path=False):
    import torch
    import torch.nn.functional as F
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(
        sum(map(ord, name)) + sq * 7 + sk)
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, k, v = mk(sq), mk(sk), mk(sk)
    kvl = sk if kv_len is None else kv_len
    kw = dict(causal=causal, kv_len=kvl, return_lse=lse)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, **kw)
    o, r = (out[0].float(), ref[0].float()) if lse else (out.float(),
                                                          ref.float())
    err = (o - r).abs()
    tol = K1_ATOL + K1_RTOL * r.abs()
    rms = lambda x: float(x.square().mean().sqrt())
    rel_rms = rms(err) / max(rms(r), 1e-30)
    ok = (bool((err <= tol).all()) and rel_rms <= K1_RMS_TOL
          and bool(torch.isfinite(o).all()))
    rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
               kv_len=kvl, max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol).max()),
               rms_ref=rms(r), mean_abs_ref=float(r.abs().mean()),
               rel_rms_err=rel_rms,
               tol=f"|err| <= {K1_ATOL} + {K1_RTOL}*|ref|, "
                   f"rms(err) <= {K1_RMS_TOL}*rms(ref)")
    if lse:
        lse_err = float((out[1] - ref[1]).abs().max())
        rec["lse_max_abs_err"] = lse_err
        ok = ok and lse_err <= K1_LSE_TOL
    if causal and sq > kvl:
        rec["zero_rows_exact"] = bool((o[:, :sq - kvl] == 0).all())
        ok = ok and rec["zero_rows_exact"]
    pairs = _valid_pairs(sq, sk, kvl, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d)
    if lse:
        nbytes += 4 * b * h * sq
    rec["bound_ms"] = max(flops / H100_BF16_FLOPS,
                          nbytes / H100_HBM_BYTES) * 1e3
    rec["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                       >= nbytes / H100_HBM_BYTES else "bytes")
    if timed:
        # device time by graph replay, without the wrapper's host cost
        # (checks, allocation, stream lookup); the wrapper with it by events
        n_launch = flash_attention.launches
        call = lambda: flash_attention(q, k, v, **kw)
        rec["ms"] = _graph_ms(call)
        rec["wrapper_ms"] = _time_ms(call, 20)
        flash_attention.launches = n_launch  # comparison launches not counted
        rec["plain_ms"] = _time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                   3, warmup=1)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        # the yardstick: one PyTorch call computing the same function, where
        # one exists (SDPA gives NaN, not zeros, for rows with no valid key)
        if not (causal and sq > kvl):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if kvl != sk or (causal and sq != sk):
                key = torch.arange(sk, device="cuda")
                mask = (key < kvl)[None, :].expand(sq, sk)
                if causal:
                    row = torch.arange(sq, device="cuda")[:, None]
                    mask = mask & (key[None, :] <= row + (kvl - sq))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None)
            rec["library_ms"] = _graph_ms(sdpa)
        else:
            rec["library_ms"] = None
    rec["ok"] = ok
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _sdpa_args(q, k, v, causal):
    """[B, H, S, D] copies and the suffix-aligned causal mask for SDPA
    (its is_causal is top-left aligned, the same only when Sq == Sk)."""
    import torch
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if causal and sq != sk:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    return qt, kt, vt, dict(attn_mask=mask, is_causal=causal and mask is None)


def _flash_bwd_case(name, b, sq, sk, h, d, *, causal=False, timed=False,
                    main_path=False):
    """The fused backward (through flash_attention_bwd) against
    flash_attention_bwd_ref in fp32 on the same bf16 inputs, with a real
    K1 forward's out and lse."""
    import torch
    from rsvldm_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    mk = lambda s: torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    n_launch = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    launched = fa.flash_attention_bwd.launches == n_launch + 1
    ref = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                     out.float(), lse, do.float(),
                                     causal=causal)
    rms = lambda x: float(x.square().mean().sqrt())
    rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
               tol=f"|err| <= {K34_ATOL}*rms(ref) + {K34_RTOL}*|ref|, "
                   f"rms(err) <= {K34_RMS_TOL}*rms(ref)")
    ok = launched
    for gname, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x.float() - r).abs()
        tol = K34_ATOL * rms(r) + K34_RTOL * r.abs()
        rel_rms = rms(err) / max(rms(r), 1e-30)
        rec[gname] = dict(max_abs_err=float(err.max()), rms_ref=rms(r),
                          max_err_over_tol=float((err / tol).max()),
                          rel_rms_err=rel_rms)
        ok = (ok and bool((err <= tol).all()) and rel_rms <= K34_RMS_TOL
              and bool(torch.isfinite(x).all()))
    if causal and sq > sk:
        rec["zero_rows_exact"] = bool((got[0][:, :sq - sk] == 0).all())
        ok = ok and rec["zero_rows_exact"]
    rec["max_abs_err"] = max(rec[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    # the kernel's work: five products (S, dP, dV, dK, dQ) over the valid
    # pairs; q, do, k, v read and dk, dv written once in bf16, lse*log2e
    # and delta read, dq added once in fp32
    flops = 5 * 2.0 * b * h * d * _valid_pairs(sq, sk, sk, causal)
    nbytes = (2 * b * h * d * (2 * sq + 4 * sk) + 4 * b * h * d * sq
              + 2 * 4 * b * h * sq)
    rec["bound_ms"] = max(flops / H100_BF16_FLOPS,
                          nbytes / H100_HBM_BYTES) * 1e3
    rec["bound_by"] = ("operations" if flops / H100_BF16_FLOPS
                       >= nbytes / H100_HBM_BYTES else "bytes")
    rec["gflop"] = flops / 1e9
    if timed:
        # device time by graph replay: the kernel alone on the prologue's
        # outputs (its dq adds pile up across replays, which costs the same),
        # and the whole backward (prologue, kernel, cast to bf16); the
        # wrapper with its host cost by events
        scale = 1.0 / d ** 0.5
        aux, dq_acc = fa._bwd_prep(out, do, lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rec["ms"] = _graph_ms(lambda: fa._bwd_kernel(
            q, k, v, do, aux, dq_acc, dk, dv, causal, scale))
        call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                              causal=causal)
        rec["whole_ms"] = _graph_ms(call)
        rec["wrapper_ms"] = _time_ms(call, 10)
        # comparison launches not counted
        fa.flash_attention_bwd.launches = n_launch
        rec["plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal=causal), 3, warmup=1)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        # the yardstick: SDPA's backward (dq, dk and dv in one call), timed
        # only; SDPA gives NaN, not zeros, for rows with no valid key
        if not (causal and sq > sk):
            rec.update(_sdpa_bwd_times(q, k, v, do, causal))
        else:
            rec["library_ms"] = None
    rec["ok"] = bool(ok)
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _sdpa_bwd_times(q, k, v, do, causal):
    """SDPA's backward: `library_ms` by graph replay of autograd.grad alone
    (the forward runs once on a side stream before the capture; autograd
    runs each backward op on its forward's stream, which is the capturing
    one), `library_wrapper_ms` by events over host launches after a forward
    on the current stream, and the backward op autograd recorded. Each run
    takes fresh leaves, so that no autograd node is bound to the other's
    stream."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt, kw = _sdpa_args(q, k, v, causal)
    dot = do.transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    rec = {}
    for stream in (side, None):
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        with torch.cuda.stream(stream):
            o = F.scaled_dot_product_attention(*leaves, **kw)
        grad = lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True)
        if stream is None:
            rec["library_wrapper_ms"] = _time_ms(grad, 10)
        else:
            rec["library_ms"] = _graph_ms(grad, stream=stream)
        rec["library_op"] = o.grad_fn.name()
    return rec


def _k2_inputs(name, r, inf, out):
    """Seeded int4 weights [inf, out] and a bf16 x [r, inf] on the card."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
    w = torch.randn((inf, out), generator=gen, device="cuda") * inf ** -0.5
    ql = quant.quantize_weight_int4(w)
    del w
    x = torch.randn((r, inf), generator=gen, device="cuda").to(torch.bfloat16)
    return x, ql


def _k2_bytes(r, inf, out):
    """What K2 must move: bf16 x in, packed weights and fp32 scales, bf16
    y out."""
    return r * inf * 2 + inf // 2 * out + inf // 128 * out * 4 + r * out * 2


def _k2_case(name, r, inf, out, *, main_path=False, x=None):
    """K2 (through int4_matmul, the wrapper that launches it) against
    int4_matmul_ref on the same bf16 input and int4 weights: y in fp32
    within the tolerance, y in bf16 equal to the fp32 y rounded."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    x0, ql = _k2_inputs(name, r, inf, out)
    x = x0 if x is None else x
    n_launch = quant.int4_matmul.launches
    y = quant.int4_matmul(x, ql, torch.float32)
    y16 = quant.int4_matmul(x, ql, torch.bfloat16)
    torch.cuda.synchronize()
    launched = quant.int4_matmul.launches == n_launch + 2
    ref = quant.int4_matmul_ref(x, ql)
    # sum over groups of |xs * ws * acc|: the scale of the fp32 sums
    xq, xs = quant.quantize_acts_grouped(x, quant.K2_GROUP)
    q = quant.unpack_int4(ql.packed).reshape(inf // quant.K2_GROUP,
                                             quant.K2_GROUP, out)
    mag = torch.zeros_like(ref)
    for g in range(q.shape[0]):
        mag += (xq[:, g].float() @ q[g].float()).abs() * xs[:, g] * ql.scale[g]
    err = (y - ref).abs()
    tol = K2_RTOL * mag + K2_ATOL
    cast_exact = bool(torch.equal(y16, y.to(torch.bfloat16)))
    ok = bool(launched and (err <= tol).all() and torch.isfinite(y).all()
              and cast_exact)
    plan = quant.k2_plan(r, inf, out,
                         quant._sm_count(torch.cuda.current_device()))
    rec = dict(case=name, shape=[r, inf, out], plan=list(plan),
               max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol).max()),
               max_abs_ref=float(ref.abs().max()), bf16_out_is_cast=cast_exact,
               tol=f"|err| <= {K2_RTOL}*sum|terms| + {K2_ATOL}")
    nbytes = _k2_bytes(r, inf, out)
    ops = 2.0 * r * inf * out
    rec["bound_ms"] = max(nbytes / H100_HBM_BYTES, ops / H100_INT8_OPS) * 1e3
    rec["bound_by"] = ("bytes" if nbytes / H100_HBM_BYTES
                       >= ops / H100_INT8_OPS else "operations")
    # the whole projection is the one launch, bf16 in and out as in decode:
    # device time by graph replay, the wrapper with its host cost by events
    call = lambda: quant.int4_matmul(x, ql)
    rec["ms"] = _graph_ms(call)
    rec["wrapper_ms"] = _time_ms(call, 20)
    quant.int4_matmul.launches = n_launch  # comparison launches not counted
    rec["plain_ms"] = _time_ms(lambda: quant.int4_matmul_ref(x, ql), 3,
                               warmup=1)
    rec["gbps"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec.update(_k2_library(x, ql, ref))
    rec["ok"] = ok
    rec["main_path"] = main_path
    _say("kernels", **rec)
    return rec


def _k2_ties():
    """bf16 x of half-integers with every group's amax 127, so the scale is
    exactly 1 and every x / s is a tie: K2's codes must round half to even
    as the plain version's do (half away from zero moves half the codes)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    r, inf = 4, 4096
    x = torch.randint(-127, 127, (r, inf), generator=gen, device="cuda") + 0.5
    x[:, ::128] = 127.0  # one 127 in each group
    x[:, 1::256] = -127.0
    return _k2_case("ties_half_even", r, inf, 4096,
                    x=x.to(torch.bfloat16))


def _k2_zero_rows():
    """A row of zeros (scale clamped to 1e-12, codes 0: y exactly 0), a row
    with one zero group, and a call with no rows (no launch)."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    x, ql = _k2_inputs("zero_rows", 4, 4096, 4096)
    x[1] = 0
    x[3, 256:384] = 0
    rec = _k2_case("zero_rows", 4, 4096, 4096, x=x)
    n_launch = quant.int4_matmul.launches
    y = quant.int4_matmul(x, ql, torch.float32)
    empty = quant.int4_matmul(x[:0], ql)
    torch.cuda.synchronize()
    rec["zero_row_exact"] = bool((y[1] == 0).all())
    rec["no_rows"] = dict(shape=list(empty.shape),
                          launched=quant.int4_matmul.launches - n_launch - 1)
    quant.int4_matmul.launches = n_launch
    rec["ok"] = bool(rec["ok"] and rec["zero_row_exact"]
                     and rec["no_rows"] == dict(shape=[0, 4096], launched=0))
    _say("kernels", case="zero_rows", zero_row_exact=rec["zero_row_exact"],
         no_rows=rec["no_rows"], ok=rec["ok"])
    return rec


def _k2_one_launch():
    """Under torch.profiler, one int4_matmul call on the card runs exactly
    one device kernel, K2's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.ops import quant
    x, ql = _k2_inputs("one_launch", 1, 4096, 14336)
    n_launch = quant.int4_matmul.launches
    quant.int4_matmul(x, ql)  # first use: library, counters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        quant.int4_matmul(x, ql)
        torch.cuda.synchronize()
    quant.int4_matmul.launches = n_launch
    rows, _ = _device_kernels(prof)
    rec = dict(case="one_launch_per_call", shape=[1, 4096, 14336],
               device_kernels=[[k[:60], c] for k, _, c in rows])
    rec["ok"] = bool(sum(c for _, _, c in rows) == 1
                     and "int4_decode_kernel" in rows[0][0])
    _say("kernels", **rec)
    return rec


def _k2_library(x, ql, ref):
    """Yardstick, never called by the port: PyTorch's int4 weight-only
    product (tinygemm) on the same int4 weights repacked, bf16 activations
    (no activation quantization, so its error vs ref is reported, not
    held); torch.matmul against the bf16-dequantized weight where that op
    is missing or refuses the shape. Device time by graph replay
    (`library_ms`), and by events over host launches beside it."""
    import torch
    from rsvldm_tpu_torch.ops import quant
    inf, out = 2 * ql.packed.shape[0], ql.packed.shape[1]
    gb = ql.scale.shape[0]
    q = quant.unpack_int4(ql.packed)                       # [in, out]
    try:
        u = (q.t().to(torch.int32) + 8)                    # [out, in] 1..15
        packed = (u[:, 0::2] << 4 | u[:, 1::2]).to(torch.uint8).contiguous()
        w4 = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([ql.scale, torch.zeros_like(ql.scale)], -1)
        sz = sz.to(torch.bfloat16).contiguous()            # [Gb, out, 2]
        call = lambda: torch._weight_int4pack_mm(x, w4, inf // gb, sz)
        which = "torch._weight_int4pack_mm"
        y = call()
    except (RuntimeError, AttributeError, TypeError) as e:
        wd = (q.float() * ql.scale.repeat_interleave(inf // gb, 0)).to(x.dtype)
        call = lambda: torch.matmul(x, wd)
        which = f"torch.matmul on the bf16-dequantized weight ({e!r:.80})"
        y = call()
    torch.cuda.synchronize()
    return dict(library=which, library_ms=_graph_ms(call),
                library_wrapper_ms=_time_ms(call, 20),
                library_max_abs_err_vs_ref=float((y.float() - ref).abs().max()))


def _k2_step(k2, rows: int = 1, suffix: str = ""):
    """K2's device time per decode step of `rows` rows: sum of launches x
    time at the five shapes (cases named <shape><suffix>), beside its
    bound and tinygemm's sum."""
    by = {c["case"]: c for c in k2}
    at = lambda c, key: by[c + suffix][key]
    rec = dict(step="decode", rows=rows, launches=K2_PER_STEP,
               ms=sum(n * at(c, "ms") for c, *_, n in K2_STEP),
               bound_ms=sum(n * at(c, "bound_ms") for c, *_, n in K2_STEP),
               library_ms=sum(n * at(c, "library_ms") for c, *_, n in K2_STEP))
    _say("kernels", **{f"k2_per_decode_step{suffix}": rec})
    return rec


def phase_kernels():
    from rsvldm_tpu_torch.device import resolve_device
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    resolve_device("cuda")  # full-fp32 matmuls: the plain versions are exact
    flash_attention.launches = 0
    cases = [
        # the slice's shapes: SDXL self-attention at 64^2 and 32^2 latents
        _flash_case("sdxl_s4096", 2, 4096, 4096, 10, 64, timed=True,
                    main_path=True),
        _flash_case("sdxl_s1024", 2, 1024, 1024, 20, 64, timed=True,
                    main_path=True),
        # the Llama-3-8B prefill of a 224^2 caption (1176 image tokens + the
        # chat prompt, padded to 1280), causal, GQA repeated to 32 heads
        _flash_case("llama_prefill_s1280", 1, 1280, 1280, 32, 128,
                    causal=True, timed=True, main_path=True),
        # the training step: 4 records padded to 1536 tokens, with lse
        _flash_case("llama_train_s1536", 4, 1536, 1536, 32, 128, causal=True,
                    lse=True, timed=True, main_path=True),
        # folder mode: the batched prefill of 8 captions, and the batched
        # refinement of 4 images (CFG batch 8) at the 64^2 and 32^2 levels
        _flash_case("folder_prefill_b8_s1408", 8, 1408, 1408, 32, 128,
                    causal=True, timed=True, main_path=True),
        _flash_case("folder_sdxl_b8_s4096", 8, 4096, 4096, 10, 64, timed=True,
                    main_path=True),
        _flash_case("folder_sdxl_b8_s1024", 8, 1024, 1024, 20, 64, timed=True,
                    main_path=True),
        _flash_case("causal_sq_lt_sk", 1, 300, 700, 4, 64, causal=True),
        _flash_case("causal_sq_gt_sk", 1, 700, 300, 4, 64, causal=True,
                    lse=True),
        _flash_case("ragged_kv_len_lse", 2, 1000, 1024, 8, 128,
                    kv_len=777, lse=True),
        _flash_case("ragged_causal_lse", 1, 513, 1100, 2, 64, causal=True,
                    kv_len=1000, lse=True),
        # the edges of K1's 128-row q and 128-key K/V tiles
        _flash_case("d128_ragged_tiles", 1, 1153, 1217, 3, 128, lse=True),
        _flash_case("d128_causal_sq_gt_sk", 1, 700, 300, 4, 128, causal=True,
                    lse=True),
        _flash_case("d64_sq_lt_tile", 2, 77, 1024, 4, 64, lse=True),
    ]
    int4_matmul.launches = 0
    k2 = phase_k2()
    # the backward: the training step's attention (B=4 records of 1536
    # padded tokens, 32 heads of 128 after the GQA repeat, causal), D=64
    # non-causal, causal Sq < Sk and Sq > Sk (zero rows), ragged lengths
    bwd = [
        _flash_bwd_case("train_s1536", 4, 1536, 1536, 32, 128, causal=True,
                        timed=True, main_path=True),
        _flash_bwd_case("d64_noncausal", 2, 1024, 1024, 8, 64, timed=True),
        _flash_bwd_case("causal_sq_lt_sk", 1, 300, 700, 4, 128, causal=True),
        _flash_bwd_case("causal_sq_gt_sk", 1, 700, 300, 4, 64, causal=True),
        _flash_bwd_case("ragged_causal", 2, 1000, 1000, 4, 128, causal=True),
        _flash_bwd_case("ragged_noncausal", 1, 517, 1100, 4, 64),
        # the edges of the kernel's 128-key and 64-query tiles
        _flash_bwd_case("d128_causal_s1153", 1, 1153, 1153, 3, 128,
                        causal=True),
        _flash_bwd_case("d128_sq130_sk1100", 1, 130, 1100, 3, 128),
        _flash_bwd_case("d64_causal_s77", 2, 77, 77, 4, 64, causal=True),
        _flash_bwd_case("d128_causal_sq_gt_sk", 1, 700, 300, 4, 128,
                        causal=True),
    ]
    _reset_counts()
    return cases, k2, bwd


def phase_k2():
    """K2's cases: one Llama-3-8B decode step's shapes (R = 1), rows 8 and
    32, ragged outs (out % 16 != 0 takes byte loads), ties, zero rows; the
    one-launch check; the decode step's shapes at 8 rows (folder mode) and
    at 5 rows (the speculative verify forward, spec_k + 1 tokens); the
    sums per decode step at 1, 8 and 5 rows."""
    k2 = [_k2_case(name, 1, inf, out, main_path=True)
          for name, inf, out, _ in K2_STEP]
    k2 += [_k2_case("rows_8", 8, 4096, 4096),
           _k2_case("rows_32", 32, 4096, 4096),
           _k2_case("ragged_out_4144", 1, 4096, 4144),
           _k2_case("ragged_out_1000", 3, 512, 1000),
           # 19 pairs: no split count divides them, so the ranges are uneven
           _k2_case("uneven_splits_4864", 1, 4864, 4096),
           _k2_ties(), _k2_zero_rows(), _k2_one_launch()]
    # folder mode: a decode step of the batched caption, 8 rows
    k2 += [_k2_case(name + "_r8", 8, inf, out, main_path=True)
           for name, inf, out, _ in K2_STEP]
    # speculative decoding: the verify forward of spec_k + 1 = 5 tokens
    k2 += [_k2_case(name + "_r5", SPEC_K + 1, inf, out, main_path=True)
           for name, inf, out, _ in K2_STEP]
    _k2_step(k2)
    _k2_step(k2, rows=8, suffix="_r8")
    _k2_step(k2, rows=SPEC_K + 1, suffix="_r5")
    return k2


def _reset_counts():
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    flash_attention.launches = int4_matmul.launches = 0
    flash_attention_bwd.launches = 0


def _counts():
    from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                      flash_attention_bwd)
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    return dict(k1=flash_attention.launches, k2=int4_matmul.launches,
                bwd=flash_attention_bwd.launches)


def _same(graph, direct) -> dict:
    """Graph replay's result against the direct call's."""
    import torch
    a, b = graph.float(), direct.float()
    err = float((a - b).abs().max())
    scale = max(1.0, float(b.abs().max()))
    return dict(max_abs_diff=err, bit_equal=bool(torch.equal(a, b)),
                finite=bool(torch.isfinite(a).all()),
                ok=bool(err <= GRAPH_TOL * scale and torch.isfinite(a).all()))


def _graph_vs_direct(pipe, seed: int, sr3_steps: int, sr3_size: int,
                     latent: int, edm_cases, ddim: bool = False) -> dict:
    """The loops' step functions on the card, once replayed as CUDA graphs
    and once called directly, on the same inputs: SR3 (`sr3_steps` steps
    of a schedule that long, a sr3_size^2 image), with `ddim` DDIM over
    the same schedule, RestoreEDM for each (name, steps, img_threshold,
    dec_img) of `edm_cases` on a latent^2 latent (CFG batch 2, churn on;
    dec_img 0 makes every step a miss: the threshold falls to 0 after the
    first measured change)."""
    import torch
    from rsvldm_tpu_torch.diffusion.samplers import (RestoreEDMConfig,
                                                     restore_edm_sample)
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
    from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion,
                                                       sr3_sample,
                                                       sr3_sample_ddim)

    modes = (True, False)
    gen_ = torch.Generator(device=pipe.device).manual_seed(seed)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=gen_,
                                                   device=pipe.device, dtype=dt)
    rec = {}
    s1 = pipe.cfg.stage1
    diff = SR3Diffusion.from_schedule(s1.schedule, sr3_steps, s1.linear_start,
                                      s1.linear_end)
    cond = rnd(1, sr3_size, sr3_size, 3).clamp(-1, 1)
    noise = rnd(sr3_steps + 1, 1, sr3_size, sr3_size, 3)
    samplers = {"sr3": sr3_sample}
    if ddim:
        samplers["ddim"] = lambda *a, **k: sr3_sample_ddim(
            *a, num_steps=sr3_steps, eta=0.5, **k)
    for name, fn in samplers.items():
        st = {m: {} for m in modes}
        out = {m: fn(diff, pipe.sr3, cond, noise, graphs=m, stats=st[m])
               for m in modes}
        rec[name] = dict(steps=sr3_steps, size=sr3_size,
                         capture_s=st[True]["capture_s"],
                         **_same(out[True], out[False]))
    den = ControlDenoiser(unet=pipe.unet, control_net=pipe.control)
    c = pipe.sdxl_cfg
    mk = lambda: dict(crossattn=rnd(1, 77, c.context_dim, dt=pipe.dtype),
                      vector=rnd(1, c.adm_in_channels),
                      control=rnd(1, latent, latent, 4))
    cond2, uc = mk(), mk()
    for name, steps, threshold, dec in edm_cases:
        x0, xc = rnd(1, latent, latent, 4), rnd(1, latent, latent, 4)
        churn = rnd(steps, 1, latent, latent, 4)
        scfg = RestoreEDMConfig(num_steps=steps, img_threshold=threshold,
                                dec_img=dec)
        st = {m: {} for m in modes}
        res = {m: restore_edm_sample(den, cond2, uc, x0, xc, scfg,
                                     churn_noise=churn, return_aux=True,
                                     graphs=m, stats=st[m]) for m in modes}
        traces = {m: "".join("H" if h else "." for h in res[m][1]["hit_trace"])
                  for m in modes}
        same = _same(res[True][0], res[False][0])
        rec[f"edm_{name}"] = dict(
            steps=steps, latent=latent, img_threshold=threshold,
            trace=traces[True], traces_equal=traces[True] == traces[False],
            capture_s=st[True]["capture_s"], **same)
        want = {"misses": "." * steps, "miss": "." * steps,
                "hits": "." + "H" * (steps - 1), "hit": "." + "H" * (steps - 1)}
        rec[f"edm_{name}"]["ok"] = (same["ok"] and traces[True] == traces[False]
                                    and traces[True] == want.get(name,
                                                                 traces[True]))
    rec["ok"] = all(v["ok"] for v in rec.values())
    return rec


def _decode_vs_direct(llama, embeds, new_tokens: int) -> dict:
    """The caption decode of `new_tokens` tokens after `embeds` (T = 0.2,
    the default Gumbel stream), once replayed as a CUDA graph and once
    called directly: the ids and the steps run must be equal. K2's
    launches of each, counted through the replays."""
    import numpy as np
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    gcfg = gen.GenerateConfig(max_new_tokens=new_tokens, temperature=0.2)
    st, ids, k2 = {}, {}, {}
    for m in (True, False):
        st[m] = {}
        before = int4_matmul.launches
        ids[m] = gen.generate(llama, embeds, gcfg, graphs=m, stats=st[m])
        k2[m] = int4_matmul.launches - before
    return dict(new_tokens=new_tokens, steps=st[True]["decode_steps"],
                capture_s=st[True]["capture_s"], ids=ids[True][:8].tolist(),
                k2_launches=k2[True],
                ok=bool(np.array_equal(ids[True], ids[False])
                        and st[True]["decode_steps"] == st[False]["decode_steps"]
                        and k2[True] == k2[False]))


# --------------------------------------------------------------- phase 4
def _small_cfgs(vae=None):
    """The small-width model configs of the reference phases; 64-channel
    heads so the self-attention at the 32^2 level (1024 tokens of a 64^2
    latent) and the ZeroCrossAttn there run on K1."""
    from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
    from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    return dict(
        sr3=SR3UNetConfig(inner_channel=32, norm_groups=8, channel_mults=(1, 2),
                          attn_res=(8,), res_blocks=1, image_size=16),
        sdxl=SDXLUNetConfig(model_channels=64, num_res_blocks=1,
                            attention_resolutions=(2,), channel_mult=(1, 2),
                            num_head_channels=64, transformer_depth=(1, 1),
                            context_dim=64, adm_in_channels=32 + 3 * 512),
        vae=vae or VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        clip_l=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2),
        big_g=CLIPTextConfig(vocab_size=1000, width=32, layers=2, heads=2,
                             quick_gelu=False, use_text_projection=True,
                             openclip=True))


def _card_vs_cpu(seed: int, small: dict, refine: dict, names, lr_side: int = 4):
    """process() of a seeded lr_side^2 tile (x4, 8 SR3 steps) at the `small`
    width on the CPU in fp32, then on the card in bf16 with the CPU's
    weights and draws. (record with the uint8 differences of each PNG of
    `names`, whether all are within REF_MEAN_TOL / REF_MAX_TOL, the card's
    pipeline)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import (PipelineConfig, RefinementConfig,
                                         Stage1Config)
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.pipeline import (ReplayNoise, SuperResolutionPipeline,
                                           TorchNoise)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ref_"))
    rng = np.random.default_rng(seed + 1)
    Image.fromarray((rng.random((lr_side, lr_side, 3)) * 255).astype(np.uint8)
                    ).save(work / "lr.png")

    def cfg(out):
        return PipelineConfig(input_img=str(work / "lr.png"),
                              output_dir=str(work / out), upscale=4,
                              seed=seed, no_llava=True,
                              params_dtype="fp32" if out == "cpu" else "bf16",
                              stage1=Stage1Config(steps=8),
                              refine=RefinementConfig(**refine))

    draws: dict = {}
    cpu_noise = TorchNoise(seed, torch.device("cpu"))

    def recording(name, shape):
        draws.setdefault(name, []).append(cpu_noise(name, shape).clone())
        return draws[name][-1]

    cpu = SuperResolutionPipeline(cfg("cpu"), device="cpu", model_cfgs=small,
                                  noise=recording)
    cpu.process()
    sds = {fam: getattr(cpu, fam).state_dict() for fam in
           ("sr3", "unet", "control", "vae", "clip_l", "big_g")}
    gpu = SuperResolutionPipeline(cfg("gpu"), device="cuda", model_cfgs=small,
                                  state_dicts=sds, noise=ReplayNoise(draws))
    flash_attention.launches = 0
    gpu.process()
    rec = dict(k1_launches=flash_attention.launches)
    ok = True
    for name in names:
        a = np.asarray(Image.open(work / "cpu" / name), np.int16)
        b = np.asarray(Image.open(work / "gpu" / name), np.int16)
        d = np.abs(a - b)
        rec[name] = dict(shape=list(a.shape), mean_abs=float(d.mean()),
                         max_abs=int(d.max()))
        ok = ok and a.shape == b.shape and d.mean() <= REF_MEAN_TOL \
            and d.max() <= REF_MAX_TOL
    rec["tol"] = f"mean <= {REF_MEAN_TOL}, max <= {REF_MAX_TOL} uint8 levels"
    return rec, ok, gpu


def phase_reference(seed: int):
    """process() at a small width on the card (bf16, K1 at 1024 tokens)
    against the same run on the CPU in fp32, with the same weights and the
    same noise. Cache off, so no threshold decision can flip between the two
    precisions. Passes when the PNGs agree to REF_MEAN_TOL mean and
    REF_MAX_TOL max uint8 levels."""
    rec, ok, gpu = _card_vs_cpu(seed, _small_cfgs(),
                                dict(min_size=128, edm_steps=4, img_threshold=0.0),
                                ("sr3_lr.png", "lr_final_0.png"))
    ok = ok and rec["k1_launches"] > 0
    # the same step functions replayed as graphs and called directly, at
    # this width: 64^2 latents put the 32^2 level's attention on K1
    rec["graphs"] = _graph_vs_direct(
        gpu, seed, sr3_steps=8, sr3_size=16, latent=64, ddim=True,
        edm_cases=(("mixed", 8, 0.3, 1.0), ("misses", 4, 0.3, 0.0),
                   ("hits", 4, 1e9, 1.0)))
    rec["graph_tol"] = (f"max |graph - direct| <= {GRAPH_TOL} * max(1, "
                        "max |direct|); ids and traces equal")
    rec["ok"] = bool(ok and rec["graphs"]["ok"])
    _say("reference", **rec)
    return rec


def phase_tiled_reference(seed: int):
    """The tiled VAE at a small width, card (bf16) against CPU (fp32):
    process() with use_tile_vae on a VAE with three downsamples (the
    stitch's factor 8), a 32^2 tile: Stage 1 at 128^2 and a 128^2
    refinement cut into 48-pixel encoder tiles (3 x 3, overlapping) and
    10-latent decoder tiles (2 x 2, overlapping), GroupNorm statistics
    pooled over the tiles; the final PNG (128^2) within the reference
    phase's tolerance."""
    from rsvldm_tpu_torch.models.vae.model import VAEConfig
    vae = VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    rec, ok, gpu = _card_vs_cpu(
        seed, _small_cfgs(vae),
        dict(min_size=128, edm_steps=4, img_threshold=0.0, use_tile_vae=True,
             encoder_tile_size=48, decoder_tile_size=10), ("lr_final_0.png",),
        lr_side=32)
    rec["tiles_used"] = gpu._use_tiles((128, 128))
    rec["finite"] = all(gpu.outputs_finite.values())
    rec["ok"] = bool(ok and rec["tiles_used"] and rec["finite"])
    _say("reference", tiled_vae=rec)
    return rec


def _acts_quantized_alike(x):
    """Whether `quantize_acts` and `quantize_acts_grouped` give the card the
    CPU's int8 codes and fp32 scales, bit for bit, for x (CPU, bf16 values)
    and for rows whose amax is where a multiply by 1/127 differs from the
    division by 127 in fp32 (the quantizers divide exactly on both)."""
    import numpy as np
    import torch
    from rsvldm_tpu_torch.ops import quant
    a = (np.arange(1, 1 << 15, dtype=np.uint32) << 16).view(np.float32)
    a = a[np.isfinite(a) & (a > 1e-3) & (a < 1e3)]
    bad = a[(a * np.float32(1 / 127)) != (a / np.float32(127))][:128]
    rows = torch.rand((len(bad), x.shape[-1]), generator=torch.Generator()
                      .manual_seed(len(bad))) * 2 - 1
    rows = rows * torch.from_numpy(bad)[:, None]
    rows[:, 5] = torch.from_numpy(bad)
    x = torch.cat([x.float(), rows]).to(torch.bfloat16)
    same = {}
    for name, fn in (("quantize_acts", quant.quantize_acts),
                     ("quantize_acts_grouped",
                      lambda t: quant.quantize_acts_grouped(t, 128))):
        (qc, sc), (qg, sg) = fn(x), fn(x.cuda())
        same[name] = bool(torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu()))
    return dict(rows=x.shape[0], reciprocal_rows=len(bad), **same)


def _small_captioners(quant: str):
    """The small-width captioner on the CPU (fp32) and on the card (bf16):
    dense weights rounded to bf16 so that both sides quantize the same
    values to the same bytes. (captioners by device, llama config, vision
    config, tokenizer, whether the quantized bytes are equal)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import (NEWLINE_KEY,
                                                       PROJECTOR_PREFIX,
                                                       VISION_PREFIX,
                                                       LlavaCaptioner)
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    # K2's conditions (dim and ffn multiples of 256, group 128) and D = 128
    lcfg = LlamaConfig(vocab_size=128256, dim=512, layers=2, heads=4,
                       kv_heads=2, ffn_dim=1024)
    vcfg = CLIPVisionConfig(width=64, layers=2, heads=1)
    tok = StandInTokenizer()
    dense = LlavaCaptioner.seeded(lcfg, vcfg, tok)
    sd = {**dense.llama.state_dict(),
          **{VISION_PREFIX + k: v for k, v in dense.vision.state_dict().items()},
          **{PROJECTOR_PREFIX + k: v
             for k, v in dense.projector.state_dict().items()},
          NEWLINE_KEY: dense.image_newline}
    sd = {k: v.to(torch.bfloat16).float() for k, v in sd.items()}
    caps = {dev: LlavaCaptioner.from_state_dict(
        sd, lcfg, vcfg, tok, quant=quant, device=dev,
        dtype=torch.float32 if dev == "cpu" else torch.bfloat16)
        for dev in ("cpu", "cuda")}
    same_bytes = all(
        torch.equal(v.cpu(), caps["cpu"].llama.state_dict()[k])
        for k, v in caps["cuda"].llama.state_dict().items()
        if v.dtype == torch.int8)
    return caps, lcfg, vcfg, tok, same_bytes


def phase_caption_reference(seed: int, quant: str, steps: int = 8):
    """A small-width caption on the card (bf16) against the same captioner
    on the CPU (fp32): dense weights rounded to bf16 so that both sides
    quantize the same values to the same bytes, the same 224^2 image and
    prompt; the prefill (1280 tokens: K1) then `steps` decode steps (R = 1:
    K2 for int4) fed the CPU's greedy tokens on both sides."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul

    caps, lcfg, vcfg, tok, same_bytes = _small_captioners(quant)
    rng = np.random.default_rng(seed + 2)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    encode = lambda t: tok.encode(t)
    toks = None
    logits = {}
    for dev in ("cpu", "cuda"):
        cap = caps[dev]
        flash_attention.launches = int4_matmul.launches = 0
        with torch.inference_mode():
            emb = gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [img], encode,
                cap.image_newline, vcfg.image_size)
            s = emb.shape[0]
            s_pad = -(-s // 128) * 128
            cache = KVCache.init(lcfg, 1, s_pad + steps + 1,
                                 dtype=cap.llama.dtype, device=dev)
            lg, cache = cap.llama(
                torch.nn.functional.pad(emb, (0, 0, 0, s_pad - s))[None],
                cache, 0)
            rows = [lg[0, s - 1]]
            if toks is None:
                toks = [int(rows[0].argmax())]
            for i in range(steps):
                e = cap.llama.embed(torch.tensor([[toks[i]]], device=dev))
                lg, cache = cap.llama(e, cache, s + i)
                rows.append(lg[0, -1])
                if dev == "cpu":
                    toks.append(int(lg[0, -1].argmax()))
        torch.cuda.synchronize()
        logits[dev] = torch.stack(rows).float().cpu()
        if dev == "cpu":
            acts = _acts_quantized_alike(emb)
        launches = dict(k1=flash_attention.launches, k2=int4_matmul.launches)
    # the decode replayed as a CUDA graph against direct calls, on the card
    graphs = _decode_vs_direct(caps["cuda"].llama, emb, 40)
    a, b = logits["cpu"], logits["cuda"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    top1 = (a.argmax(-1) == b.argmax(-1)).float()
    rec = dict(quant=quant, prompt_len=s, padded_len=s_pad, steps=steps,
               cos=[round(float(c), 6) for c in cos],
               top1=[int(t) for t in top1], same_quantized_bytes=same_bytes,
               same_activation_codes=acts,
               card_launches=launches, graphs=graphs,
               tol=f"cos >= {CAP_COS_MIN} every step, top-1 agreement >= "
                   f"{CAP_TOP1_MIN}; graph ids equal to direct ids")
    rec["ok"] = bool(same_bytes and s_pad >= 1024
                     and acts["quantize_acts"] and acts["quantize_acts_grouped"]
                     and launches["k1"] == lcfg.layers
                     and (quant != "int4"
                          or launches["k2"] == steps * (7 * lcfg.layers + 1))
                     and float(cos.min()) >= CAP_COS_MIN
                     and float(top1.mean()) >= CAP_TOP1_MIN
                     and graphs["ok"]
                     # the decode steps and the prefill's lm_head
                     and (quant != "int4" or graphs["k2_launches"]
                          == graphs["steps"] * (7 * lcfg.layers + 1) + 1))
    flash_attention.launches = int4_matmul.launches = 0
    _say("reference", **rec)
    return rec


def phase_batch_caption_reference(seed: int, quant: str = "int4",
                                  steps: int = 8):
    """The batched caption (folder mode) at the small width, card (bf16)
    against CPU (fp32): three images of different shapes spliced into the
    prompt (ragged lengths), one batched prefill from 0 with the lm_head
    on each row's last real position, then `steps` decode steps of all
    three rows at their own positions, fed the CPU's greedy tokens on both
    sides. Per row: the logit cosine every step and the top-1 agreement,
    held to the single caption's limits."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    from rsvldm_tpu_torch.ops.flash_attention import flash_attention
    from rsvldm_tpu_torch.ops.quant import int4_matmul

    caps, lcfg, vcfg, tok, same_bytes = _small_captioners(quant)
    rng = np.random.default_rng(seed + 3)
    imgs = [Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))
            for h, w in ((224, 224), (168, 280), (300, 200))]
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    toks, logits = None, {}
    for dev in ("cpu", "cuda"):
        cap = caps[dev]
        flash_attention.launches = int4_matmul.launches = 0
        with torch.inference_mode():
            embs = [gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [img],
                tok.encode, cap.image_newline, vcfg.image_size) for img in imgs]
            lens = [e.shape[0] for e in embs]
            s_pad = -(-max(lens) // 128) * 128
            cache = KVCache.init(lcfg, len(embs), s_pad + steps + 1,
                                 dtype=cap.llama.dtype, device=dev)
            x = torch.stack([torch.nn.functional.pad(e, (0, 0, 0, s_pad - len(e)))
                             for e in embs])
            at = torch.tensor(lens, device=dev)
            lg, cache = cap.llama(x, cache, 0, logits_at=at - 1)
            rows = [lg[:, 0]]
            if toks is None:
                toks = [rows[0].argmax(-1).cpu()]
            for i in range(steps):
                e = cap.llama.embed(toks[i].to(dev)[:, None])
                lg, cache = cap.llama(e, cache, at + i)
                rows.append(lg[:, -1])
                if dev == "cpu":
                    toks.append(lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        logits[dev] = torch.stack(rows).float().cpu()  # [steps+1, B, vocab]
        launches = dict(k1=flash_attention.launches, k2=int4_matmul.launches)
    a, b = logits["cpu"], logits["cuda"]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)  # [steps+1, B]
    top1 = (a.argmax(-1) == b.argmax(-1)).float()
    rec = dict(quant=quant, rows=len(imgs), prompt_lens=lens, padded_len=s_pad,
               steps=steps, cos=[[round(float(c), 6) for c in r] for r in cos.T],
               top1=[[int(t) for t in r] for r in top1.T],
               same_quantized_bytes=same_bytes, card_launches=launches,
               tol=f"per row: cos >= {CAP_COS_MIN} every step, top-1 "
                   f"agreement >= {CAP_TOP1_MIN}")
    rec["ok"] = bool(same_bytes and s_pad >= 1024 and len(set(lens)) == 3
                     and launches["k1"] == lcfg.layers
                     and (quant != "int4" or launches["k2"]
                          == steps * (7 * lcfg.layers + 1) + 1)
                     and float(cos.min()) >= CAP_COS_MIN
                     and float(top1.mean(0).min()) >= CAP_TOP1_MIN)
    flash_attention.launches = int4_matmul.launches = 0
    _say("reference", batched_caption=rec)
    return rec


def _spec_round_ms(cap, draft, prompt_len: int, rounds: int = 10) -> dict:
    """Device time of a speculative round by replaying the kept sampled
    loop of `draft` `rounds` times (CUDA events; before each, its position
    and index are set back to the first round's, so every block stays
    inside the caches and tables) and the K2 launches a round counted
    through those replays; and the decode rate that round time would give
    were every proposal kept (k + 1 tokens a round: reckoned, not run)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.speculative import SpecState
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    # the loop's key: ("spec", bucket, max_new, k, greedy, ..., id(draft))
    st = next(v for key, v in cap.decode_graphs.items()
              if isinstance(v, SpecState) and key[-1] == id(draft) and not key[4])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = int4_matmul.launches
        start.record()
        for _ in range(rounds):
            st.p.fill_(prompt_len)
            st.j0.fill_(1)
            st.runner()
        end.record()
        torch.cuda.synchronize()
    k2 = int4_matmul.launches - before
    int4_matmul.launches = before  # timing launches are not the path's
    ms = start.elapsed_time(end) / rounds
    return dict(ms_per_round=ms, k2_per_round=k2 / rounds,
                tok_s_if_all_kept=(SPEC_K + 1) * 1e3 / ms,
                replayed=st.runner.graph is not None)


def _accept_card_vs_cpu(seed: int, vocab: int = 64, cases: int = 12) -> dict:
    """accept_and_correct on the card against the CPU on the same seeded
    distributions (fp32, k = SPEC_K): in case c the draft's first c % (k+1)
    distributions are the target's (kept whatever the uniform), so every
    count of kept proposals 0..k occurs, the bonus token at k. The same
    committed tokens and counts."""
    import torch
    from rsvldm_tpu_torch.models.vlm.speculative import accept_and_correct
    g = torch.Generator().manual_seed(seed + 8)
    k, same, counts = SPEC_K, True, []
    for c in range(cases):
        t = torch.softmax(torch.randn(k + 1, vocab, generator=g) * 2, -1)
        d = torch.softmax(torch.randn(k, vocab, generator=g) * 2, -1)
        m = c % (k + 1)
        d[:m] = t[:m]
        toks = torch.stack([torch.multinomial(d[i], 1, generator=g)[0]
                            for i in range(k)])
        u = torch.rand(k, generator=g)
        res = -torch.log(-torch.log(torch.rand(k, vocab, generator=g)))
        bonus = -torch.log(-torch.log(torch.rand(vocab, generator=g)))
        args = (toks, d, t, u, res, bonus)
        want = accept_and_correct(*args)
        got = accept_and_correct(*(a.cuda() for a in args))
        same = same and all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
        counts.append(int(want[1]))
    return dict(cases=cases, n_commit=counts, equal=bool(same),
                ok=bool(same and k + 1 in counts and 1 in counts))


def phase_spec_reference(seed: int, new_tokens: int = 40):
    """Speculative decoding at the small width on the card (int4, k = 4):
    with the bf16 captioner and a 1280-token prompt, greedy ids with a
    one-layer self-draft, and with the target as its own draft (every
    proposal kept, a bonus token each round), equal greedy `generate` ids
    on the card; every round after the first replayed from its graph; K1
    launches the target's layers plus the draft's (the prefills), K2
    k (7n + 1) + 7n + 7L + 1 a round plus the prefill's lm_head. Then
    sampled (T = 0.8) with the target as its own draft, in fp32 on a
    96-token prompt and fed the Gumbel rows of the `generate` run: its ids,
    and every proposal kept. And accept_and_correct on the card equals the
    CPU's (_accept_card_vs_cpu)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import (default_accept_noise,
                                                         self_draft,
                                                         speculative_generate)

    caps, lcfg, vcfg, tok, _ = _small_captioners("int4")
    cap = caps["cuda"]
    rng = np.random.default_rng(seed + 4)
    img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
    prompt = gen.llama3_chat_prompt(
        REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
    gcfg = gen.GenerateConfig(max_new_tokens=new_tokens, do_sample=False)
    L = lcfg.layers

    def run(draft, n, emb, cfg, **kw):
        st: dict = {}
        _reset_counts()
        ids = speculative_generate(cap.llama, draft, emb, cfg, SPEC_K,
                                   stats=st, **kw)
        c = _counts()
        _reset_counts()
        rec = dict(rounds=st["rounds"], replays=st["replays"],
                   accept_rate=st["accept_rate"], tokens=len(ids),
                   k1_launches=c["k1"], k2_launches=c["k2"])
        rec["replayed"] = bool(st["rounds"] >= 2
                               and st["replays"] == st["rounds"] - 1)
        return rec, ids

    with torch.inference_mode():
        emb = gen.embed_multimodal_prompt(
            cap.llama, cap.vision, cap.projector, prompt, [img], tok.encode,
            cap.image_newline, vcfg.image_size)
        ids_v = gen.generate(cap.llama, emb, gcfg)
        rec: dict = dict(new_tokens=new_tokens, prompt_len=int(emb.shape[0]))
        for name, draft, n in (("self_draft", self_draft(cap.llama, 1), 1),
                               ("draft_is_target", cap.llama, L)):
            r, ids_s = run(draft, n, emb, gcfg)
            r.update(ids=ids_s[:8].tolist(),
                     ids_equal=bool(np.array_equal(ids_v, ids_s)),
                     expected_k1=L + n,
                     expected_k2=1 + r["rounds"] * k2_per_round(n, SPEC_K, L))
            r["ok"] = bool(r["ids_equal"] and r["tokens"] == new_tokens
                           and r["replayed"]
                           and r["k1_launches"] == r["expected_k1"]
                           and r["k2_launches"] == r["expected_k2"])
            rec[name] = r
        rec["draft_is_target"]["ok"] = bool(rec["draft_is_target"]["ok"]
                                            and rec["draft_is_target"]["accept_rate"] == 1.0)
        # sampled, fp32: the 5-row verify then sums as the 1-row step does
        # to fp32 rounding, far below any acceptance uniform's resolution
        cap.llama.float()
        vocab = lcfg.vocab_size
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        toks = torch.randint(0, vocab, (96,), generator=g, device="cuda")
        emb32 = cap.llama.embed(toks)
        scfg = gen.GenerateConfig(max_new_tokens=new_tokens, temperature=0.8,
                                  do_sample=True)
        rows = gen.gumbel_noise(vocab, g, new_tokens + SPEC_K)(0)
        noise = lambda j: rows[j]
        ids_v32 = gen.generate(cap.llama, emb32, scfg, noise=noise)
        r, ids_s32 = run(cap.llama, L, emb32, scfg, noise=noise,
                         accept_noise=default_accept_noise(
                             vocab, torch.Generator(device="cuda").manual_seed(seed + 6)))
        r.update(ids=ids_s32[:8].tolist(), tokens_vanilla=len(ids_v32),
                 ids_equal=bool(np.array_equal(ids_v32, ids_s32)))
        r["ok"] = bool(r["ids_equal"] and r["replayed"]
                       and r["accept_rate"] == 1.0 and r["k1_launches"] == 0)
        rec["sampled_fp32_draft_is_target"] = r
    rec["accept_and_correct"] = _accept_card_vs_cpu(seed)
    rec["ok"] = bool(all(rec[k]["ok"] for k in (
        "self_draft", "draft_is_target", "sampled_fp32_draft_is_target",
        "accept_and_correct")))
    _say("reference", speculative=rec)
    return rec


# --------------------------------------------------------------- phase 5
CKPT_MARGIN = 1.1  # free space needed, as a multiple of the bytes written


def _split_even(sd, n: int):
    """sd's names in n consecutive groups of about equal bytes."""
    total = sum(t.numel() * t.element_size() for t in sd.values())
    groups, acc = [[] for _ in range(n)], 0
    for k, t in sd.items():
        groups[min(n - 1, acc * n // total)].append(k)
        acc += t.numel() * t.element_size()
    return groups


def _pick_dir(need: int):
    """(a new directory on the first of TMPDIR and the checkout with `need`
    bytes free, the free bytes of each)."""
    import shutil
    free = {}
    for base in (Path(tempfile.gettempdir()), REPO):
        free[str(base)] = shutil.disk_usage(base).free
        if free[str(base)] >= need:
            return Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)), free
    return None, free


def _write_ckpt_dir(cd: Path, pipe0, cap0, seed: int, prompt: str, texts):
    """The reference layout (tests/test_e2e_ckpt_roundtrip.py:182-217) from
    seeded full-width modules on the card, in bf16: SR3's .pth, the
    juggernaut safetensors (UNet, VAE without its twin encoder, both text
    towers), SR-v0Q.ckpt (GLVControl and the denoise_encoder), the LLaVA
    state dict in four safetensors shards with a tokenizer.json, a
    Llava-next PEFT adapter (r=8, alpha=16 on q_proj and v_proj of every
    layer) and clip_vocab. Returns (bytes written, the adapter's sampled
    expectations, tokenizer assets)."""
    import torch
    from rsvldm_tpu_torch.models.vlm.captioner import (NEWLINE_KEY,
                                                       PROJECTOR_PREFIX,
                                                       VISION_PREFIX)
    from rsvldm_tpu_torch.pipeline import CHECKPOINTS
    nbytes = 0
    cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
    name, _ = CHECKPOINTS["sr3"]
    torch.save(cpu(pipe0.sr3.state_dict()), cd / name[0])
    jug_name, srq_name = CHECKPOINTS["unet"][0]
    jug, srq = {}, {}
    for fam in ("unet", "vae", "clip_l", "big_g", "control"):
        prefix = CHECKPOINTS[fam][1]
        for k, v in getattr(pipe0, fam).state_dict().items():
            dst = srq if fam == "control" or k.startswith("denoise_encoder.") else jug
            dst[f"{prefix}.{k}"] = v
    nbytes += write_safetensors(cd / jug_name, jug, {"format": "pt"})
    torch.save({"state_dict": cpu(srq)}, cd / srq_name)
    del jug, srq
    sd = dict(cap0.llama.state_dict())
    sd.update({VISION_PREFIX + k: v for k, v in cap0.vision.state_dict().items()})
    sd.update({PROJECTOR_PREFIX + k: v for k, v in cap0.projector.state_dict().items()})
    sd[NEWLINE_KEY] = cap0.image_newline
    (cd / "llava").mkdir()
    for i, keys in enumerate(_split_even(sd, 4)):
        nbytes += write_safetensors(cd / "llava" / f"model-{i + 1:05d}-of-00004.safetensors",
                                    {k: sd[k] for k in keys}, {"format": "pt"})
    llama_assets = Llama3Assets([prompt], seed=seed)
    llama_assets.write(cd / "llava")
    # the PEFT adapter; the expected merge of a few layers in fp32 on the CPU
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    adapter, expect, r, alpha = {}, {}, 8, 16
    n_layers = cap0.llama.cfg.layers
    for i in range(n_layers):
        for proj in ("q_proj", "v_proj"):
            w = sd[f"model.layers.{i}.self_attn.{proj}.weight"]
            a = (torch.randn(r, w.shape[1], generator=gen, device="cuda")
                 / w.shape[1] ** 0.5).to(torch.bfloat16)
            b = (torch.randn(w.shape[0], r, generator=gen, device="cuda")
                 * 0.02).to(torch.bfloat16)
            key = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            adapter[f"{key}.lora_A.weight"], adapter[f"{key}.lora_B.weight"] = a, b
            if i in (0, n_layers // 2, n_layers - 1):
                f32 = lambda t: t.float().cpu().numpy()
                merged = f32(w) + (alpha / r) * (f32(b) @ f32(a))
                expect[(i, proj)] = (torch.from_numpy(merged).to(torch.bfloat16),
                                     w.cpu())
    (cd / "Llava-next").mkdir()
    nbytes += write_safetensors(cd / "Llava-next" / "adapter_model.safetensors",
                                adapter, {"format": "pt"})
    (cd / "Llava-next" / "adapter_config.json").write_text(json.dumps(
        {"peft_type": "LORA", "r": r, "lora_alpha": alpha,
         "target_modules": ["q_proj", "v_proj"]}))
    clip_assets = ClipAssets(texts, seed=seed)
    clip_assets.write(cd / "clip_vocab")
    total = sum(f.stat().st_size for f in cd.rglob("*") if f.is_file())
    return total, expect, llama_assets, clip_assets


def _sd_digest(sd) -> str:
    """A digest of every byte of a state dict, computed on the card: per
    tensor, the position-weighted sum of its bytes in chunks."""
    import hashlib
    import torch
    h = hashlib.sha1()
    for name, t in sorted(sd.items()):
        flat = t.detach().contiguous().view(-1).view(torch.uint8)
        total = 0
        for i, chunk in enumerate(flat.split(1 << 26)):
            pos = torch.arange(1, chunk.numel() + 1, device=chunk.device,
                               dtype=torch.int64)
            total += int((chunk.to(torch.int64) * pos).sum()) * (i + 1)
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}:{total};".encode())
    return h.hexdigest()


def _family_digests(pipe, cap) -> dict:
    """Per family, a digest of what the checkpoint holds unchanged after the
    load: every parameter of the six pipeline families, and of the
    captioner the tower, projector, image_newline, embedding and norms (its
    projections are int4 after the load)."""
    out = {fam: _sd_digest(getattr(pipe, fam).state_dict())
           for fam in ("sr3", "unet", "control", "vae", "clip_l", "big_g")}
    out["llava_vision"] = _sd_digest(cap.vision.state_dict())
    out["llava_projector"] = _sd_digest(cap.projector.state_dict())
    out["llava_newline"] = _sd_digest({"n": cap.image_newline})
    out["llava_embed_norms"] = _sd_digest(
        {k: v for k, v in cap.llama.state_dict().items()
         if "norm" in k or "embed_tokens" in k})
    return out


def _decode_launches(llama, lora=None, pos: int = 1300):
    """Device kernels launched by one int4 decode step (position `pos` of a
    1536-slot cache, a device tensor as in the caption's loop), with and
    without a runtime LoRA, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.models.vlm.llama import KVCache
    kv = KVCache.init(llama.cfg, 1, 1536, dtype=llama.dtype, device="cuda")
    tok = torch.tensor([[1000]], device="cuda")
    at = torch.tensor(pos, device="cuda")
    with torch.inference_mode():
        step = lambda: llama(llama.embed(tok), kv, at, lora=lora)[0]
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA)


def phase_path(seed: int):
    """Full-width seeded modules written as the reference checkpoint
    directory, then the pipeline built from that directory alone through
    the CLI's own construction (infer.build_pipeline --quant int4), its
    weights and tokens checked against what was written, then process().
    Returns (record, pipeline, the directory): the caller deletes the
    directory after phase `folder` has read it."""
    import shutil
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer
    from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                         RefinementConfig)
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
    from rsvldm_tpu_torch.ops.quant import quantize_weight_int4
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    from rsvldm_tpu_torch.training.vlm_trainer import (LoraConfig, init_lora,
                                                       save_lora_npz)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    rng = np.random.default_rng(seed)
    lr = (rng.random((28, 28, 3)) * 255).astype(np.uint8)
    Image.fromarray(lr).save(work / "lr.png")
    refine = RefinementConfig()
    prompt = llama3_chat_prompt(LlavaConfig().img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))
    # the modules to write: the full-width geometries with seeded bf16
    # weights (a directory with no files), LLaVA-NeXT-8B dense
    t0 = time.perf_counter()
    pipe0 = SuperResolutionPipeline(PipelineConfig(ckpt_dir=str(work / "none"),
                                                   no_llava=True), device="cuda")
    pipe0.ensure_stage2()
    cap0 = LlavaCaptioner.seeded(tokenizer=StandInTokenizer(), device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    mods = [getattr(pipe0, f) for f in ("sr3", "unet", "control", "vae", "clip_l",
                                        "big_g")] + [cap0.llama, cap0.vision, cap0.projector]
    need = sum(t.numel() * t.element_size() for m in mods
               for t in m.state_dict().values())
    # the adapter: r=8 on q_proj and v_proj of each layer, bf16
    lc = cap0.llama.cfg
    need += lc.layers * 8 * (3 * lc.dim + lc.kv_heads * lc.head_dim) * 2
    cd, free = _pick_dir(int(need * CKPT_MARGIN))
    rec = dict(ckpt_bytes_reckoned=need, free_bytes=free, seed_s=seed_s)
    if cd is None:
        rec.update(ok=False, error=f"no directory with {need * CKPT_MARGIN / 1e9:.1f} "
                   "GB free for the checkpoint directory")
        _say("path", **rec)
        return rec, None, None
    try:
        digests_written = _family_digests(pipe0, cap0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_bytes, expect, llama_assets, clip_assets = _write_ckpt_dir(
            cd, pipe0, cap0, seed, prompt, [refine.a_prompt, refine.n_prompt])
        write_s = time.perf_counter() - t0
        del pipe0, cap0, mods
        torch.cuda.empty_cache()

        # the pipeline as a user builds it: the CLI's construction, the
        # directory alone (no state dicts, no captioner)
        args = infer.parse_args([
            "--input_img", str(work / "lr.png"), "--output_dir", str(work / "out"),
            "--seed", str(seed), "--ckpt_dir", str(cd), "--quant", "int4"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = infer.build_pipeline(args)
        pipe.ensure_stage2()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cap = pipe.llava
        load_peak = torch.cuda.max_memory_allocated() / 2**30
        sources = pipe.weight_sources
        from_files = all(isinstance(sources.get(f), list) and sources[f]
                         for f in ("sr3", "unet", "control", "vae", "clip_l", "big_g"))
        digests = _family_digests(pipe, cap) if cap is not None else {}
        digests_equal = {k: digests.get(k) == v for k, v in digests_written.items()}
        peft = {}
        for (i, proj), (merged, plain) in expect.items():
            mod = getattr(cap.llama.model.layers[i].self_attn, proj)
            q = quantize_weight_int4(merged.cuda().t(), 128)
            q0 = quantize_weight_int4(plain.cuda().t(), 128)
            peft[f"{i}.{proj}"] = bool(torch.equal(q.packed, mod.kernel_q4)
                                       and torch.equal(q.scale, mod.scale)
                                       and not torch.equal(q0.packed, mod.kernel_q4))
        chunks = prompt.split("<image>")
        llama_ids_equal = all(cap.tokenizer.encode(c) == llama_assets.encode(c)
                              for c in chunks)
        clip_ids_equal = all(
            [pipe.tokenizer.sot, *pipe.tokenizer.encode(t), pipe.tokenizer.eot]
            == clip_assets.encode(t) for t in (refine.a_prompt, refine.n_prompt))
        ls = cap.load_stats
        load_s = dict(pipe.load_s, llava_split={k: ls[k] for k in (
            "open_s", "merge_s", "read_s", "quantize_s")})
        read_s = sum(v for k, v in pipe.load_s.items())
        torch.cuda.reset_peak_memory_stats()

        _reset_counts()
        t0 = time.perf_counter()
        pipe.process()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = _counts()
        launches, k2_launches = counts["k1"], counts["k2"]
        cs = pipe.caption_stats
        capture_s = dict(pipe.capture_s)
        process_peak = torch.cuda.max_memory_allocated() / 2**30

        # the loops' steps replayed as graphs against direct calls at full
        # width: 16 decode steps, 10 SR3 steps, a denoiser's miss steps
        # (the rest graph) and hit steps (the update graph)
        sr_img = Image.open(work / "out" / "sr3_lr.png").convert("RGB")
        with torch.inference_mode():
            emb = gen.embed_multimodal_prompt(
                cap.llama, cap.vision, cap.projector, prompt, [sr_img],
                lambda t: cap.tokenizer.encode(t, add_special_tokens=False),
                cap.image_newline, cap.vision.cfg.image_size)
        graphs = _graph_vs_direct(pipe, seed, sr3_steps=10, sr3_size=224,
                                  latent=128,
                                  edm_cases=(("miss", 3, 0.3, 0.0),
                                             ("hit", 3, 1e9, 1.0)))
        graphs["decode"] = _decode_vs_direct(cap.llama, emb, 17)
        graphs["ok"] = graphs["ok"] and graphs["decode"]["ok"]
        del emb

        # Stage 1 as DDIM at full width (the config's 50 steps)
        pipe.cfg.stage1.sampler = "ddim"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_stage1(str(work / "lr.png"))
        torch.cuda.synchronize()
        ddim = dict(steps=pipe.cfg.stage1.ddim_steps, eta=pipe.cfg.stage1.ddim_eta,
                    seconds=time.perf_counter() - t0,
                    capture_s=pipe.capture_s["stage1"],
                    finite=pipe.outputs_finite["stage1"])
        pipe.cfg.stage1.sampler = "ddpm"

        # one decode step's kernel launches, then with a train_vlm LoRA
        # archive (r=16 on the seven projections of every layer) attached
        # as the int4 decoder's runtime branch
        lora = init_lora(cap.llama, LoraConfig())
        for ab in lora.values():
            ab["b"].normal_(0.0, 0.01)
        save_lora_npz(lora, LoraConfig(), work / "lora.npz")
        decode_launches = _decode_launches(cap.llama)
        cap.attach_archives(lora_npz=work / "lora.npz")
        decode_launches_lora = _decode_launches(cap.llama, cap.lora)
        cap.lora = None
    except BaseException:
        shutil.rmtree(cd, ignore_errors=True)
        raise

    sr = np.asarray(Image.open(work / "out" / "sr3_lr.png"))
    fin = np.asarray(Image.open(work / "out" / "lr_final_0.png"))
    dfb = pipe.last_dfb
    n_params = sum(p.numel() for m in (pipe.sr3, pipe.unet, pipe.control,
                                       pipe.vae, pipe.clip_l, pipe.big_g)
                   for p in m.parameters())
    caption_bytes = sum(t.numel() * t.element_size()
                        for m in (cap.llama, cap.vision, cap.projector)
                        for t in [*m.parameters(), *m.buffers()])
    rec.update(
        ckpt_dir=str(cd), ckpt_bytes=ckpt_bytes, write_s=write_s,
        write_gbps=ckpt_bytes / write_s / 1e9,
        load_s=load_s, init_s=init_s,
        read_gbps=ckpt_bytes / read_s / 1e9,
        read_note="page cache warm: the files were written just before",
        load_peak_mem_gib=load_peak,
        weight_sources={k: [Path(p).name for p in v] if isinstance(v, list) else v
                        for k, v in sources.items()},
        digests_equal=digests_equal, peft_projections_equal=peft,
        peft_merged=ls.get("peft_merged"),
        llama_ids_equal=llama_ids_equal, clip_ids_equal=clip_ids_equal,
        process_s=total_s,
        stage_s=dict(pipe.timings), params=n_params,
        stage1_steps=pipe.cfg.stage1.steps,
        edm_steps=pipe.cfg.refine.edm_steps, dfb_hits=dfb["hits"],
        dfb_steps=dfb["steps"],
        dfb_trace="".join("H" if x else "." for x in dfb["trace"]),
        flash_fwd_launches=launches, int4_decode_launches=k2_launches,
        launches=counts,
        caption_weights_gib=caption_bytes / 2**30,
        caption_s=pipe.timings.get("caption", 0.0),
        prompt_len=cs.get("prompt_len"), padded_len=cs.get("padded_len"),
        prefill_s=cs.get("prefill_s", 0.0), decode_s=cs.get("decode_s", 0.0),
        decode_steps=cs.get("decode_steps"),
        decode_tok_s=cs["decode_steps"] / cs["decode_s"]
        if cs.get("decode_s") else None,
        decode_launches_per_step=decode_launches,
        decode_launches_per_step_lora=decode_launches_lora,
        caption_words=len(pipe.last_caption.split()),
        capture_s=capture_s, peak_mem_gib=process_peak,
        peak_mem_gib_with_checks=torch.cuda.max_memory_allocated() / 2**30,
        graphs=graphs, ddim_stage1=ddim,
        sr3_png=list(sr.shape), final_png=list(fin.shape),
        sr3_path=str(work / "out" / "sr3_lr.png"),
        outputs_finite=pipe.outputs_finite,
        sr3_std=float(sr.std()), final_std=float(fin.std()))
    misses = dfb["steps"] - dfb["hits"]
    rec["expected_launches"] = (misses * K1_PER_MISS + dfb["hits"] * K1_PER_HIT
                                + K1_PER_CAPTION)
    # the decode steps, and the prefill's lm_head on the last position
    rec["expected_k2_launches"] = K2_PER_STEP * (cs.get("decode_steps") or 0) + 1
    ok = bool(from_files and cap is not None
              and isinstance(sources.get("llava"), list)
              and all(digests_equal.values()) and len(peft) == 6
              and all(peft.values()) and ls.get("peft_merged") == 64
              and llama_ids_equal and clip_ids_equal
              and launches == rec["expected_launches"] > 0
              and k2_launches == rec["expected_k2_launches"] > 0
              and cs.get("padded_len", 0) >= 1024
              and sr.shape == (224, 224, 3)
              and fin.shape == (224, 224, 3)
              and all(pipe.outputs_finite.values())
              and sr.std() > 0 and fin.std() > 0
              and graphs["ok"] and ddim["finite"])
    rec["ok"] = ok
    _say("path", **rec)
    return rec, pipe, cd


# -------------------------------------------------------------- phase 5s
def _write_draft_dir(dd: Path, cfg, seed: int) -> int:
    """A seeded Llama draft checkpoint (`cfg`, weights of its own seed, not
    the target's) as a user has one: config.json and one safetensors file
    of HF-named bf16 tensors. Returns the bytes written."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import LlamaModel
    from rsvldm_tpu_torch.utils.weights import seeded_init_
    with torch.device("meta"):
        draft = LlamaModel(cfg)
    draft = draft.to(torch.bfloat16).to_empty(device="cuda")
    seeded_init_(draft, f"llama_draft_{seed}", torch.device("cuda"))
    dd.mkdir()
    (dd / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "hidden_size": cfg.dim,
        "intermediate_size": cfg.ffn_dim, "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads, "num_key_value_heads": cfg.kv_heads,
        "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16"}))
    n = write_safetensors(dd / "model.safetensors", draft.state_dict(),
                          {"format": "pt"})
    del draft
    torch.cuda.empty_cache()
    return n


def _spec_run(cap, emb, gcfg, draft=None, n_layers: int = 0) -> dict:
    """One caption decode of the spliced prompt `emb`: vanilla
    (generate) without a draft, else speculative rounds with it (k =
    SPEC_K). Seconds, tokens/s, rounds, acceptance, capture seconds,
    replays and K1 / K2 launches (counts reset just before, read just
    after: K1 is the target's prefill and the draft's, K2 the decode's),
    and the ids."""
    import torch
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import speculative_generate
    layers = cap.llama.cfg.layers
    st: dict = {}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    if draft is None:
        ids = gen.generate(cap.llama, emb, gcfg, stats=st,
                           graph_cache=cap.decode_graphs)
    else:
        ids = speculative_generate(cap.llama, draft, emb, gcfg, SPEC_K,
                                   stats=st, graph_cache=cap.decode_graphs)
    torch.cuda.synchronize()
    n = _counts()
    rec = dict(caption_s=time.perf_counter() - t0, tokens=len(ids),
               prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               capture_s=st["capture_s"], k1_launches=n["k1"],
               k2_launches=n["k2"], expected_k1=layers + n_layers)
    # tokens after the prefill's first one, over the decode's seconds
    rec["decode_tok_s"] = (len(ids) - 1) / st["decode_s"] if st["decode_s"] else None
    if draft is not None:
        rec.update({k: st[k] for k in ("rounds", "proposed", "accepted",
                                       "accept_rate", "replays")})
        rec["draft_layers"] = n_layers
        rec["k2_per_round_formula"] = k2_per_round(n_layers, layers=layers)
        rec["k2_launches_per_round"] = ((rec["k2_launches"] - 1) / st["rounds"]
                                        if st["rounds"] else None)
        rec["ok"] = bool(st["rounds"] >= 2 and st["replays"] == st["rounds"] - 1
                         and rec["k2_launches"] - 1
                         == st["rounds"] * rec["k2_per_round_formula"])
    else:
        rec["ok"] = rec["k2_launches"] == K2_PER_STEP * st["decode_steps"] + 1
    rec["ok"] = bool(rec["ok"] and rec["k1_launches"] == rec["expected_k1"])
    _reset_counts()
    return rec, ids


def _greedy_gap(cap, emb, ids_v, ids_s) -> dict:
    """The prefix on which two greedy id streams agree and, where they
    part, the target's logits there: its top-2 gap and the logits of the
    two streams' tokens."""
    import numpy as np
    import torch
    n = min(len(ids_v), len(ids_s))
    m = next((i for i in range(n) if ids_v[i] != ids_s[i]), n)
    rec = dict(agree_prefix=m, lengths=[len(ids_v), len(ids_s)],
               equal=bool(np.array_equal(ids_v, ids_s)))
    if m < n:
        with torch.inference_mode():
            prev = torch.tensor(ids_v[:m], device=emb.device, dtype=torch.long)
            x = torch.cat([emb, cap.llama.embed(prev).to(emb.dtype)])[None]
            lg, _ = cap.llama(x, None, 0, logits_at=torch.tensor(
                [x.shape[1] - 1], device=emb.device))
        lg = lg[0, 0].float()
        top = lg.topk(2).values
        rec.update(top2_gap=float(top[0] - top[1]),
                   logit_vanilla=float(lg[int(ids_v[m])]),
                   logit_spec=float(lg[int(ids_s[m])]))
    return rec


def phase_spec(seed: int, pipe, cd: Path, sr_path: str):
    """Speculative caption decoding at full width, on the path's int4
    captioner and its Stage-1 image: the 256-token caption at T = 0.2
    three ways (vanilla; the self-draft of the first SELF_DRAFT_LAYERS
    layers, k = SPEC_K; a seeded DRAFT_LAYERS-layer draft checkpoint of
    the target's width and vocabulary written to <cd>/llava_draft and read
    through the CLI's construction, infer.build_pipeline --draft_dir);
    per run the caption's seconds, decode tok/s, rounds, acceptance, ms a
    round by graph replay, capture seconds and K2 launches a round; then
    the same three greedy (T = 0): the prefix on which the speculative ids
    agree with the vanilla ones and the target's top-2 gap where they
    part (reported; a 5-row verify and a 1-row step sum in other orders).
    Then the target as its own draft (n = 32), sampled with the vanilla
    run's draws: the accept branch at full width, its acceptance, round
    time, and the prefix it shares with the vanilla ids (a report). Each
    draft's round time also gives the rate were every proposal kept.
    Fails if a round is not replayed from its graph, if K2's launches a
    round are not k (7n + 1) + 7n + 225, if K1's a run are not 32 + n (the
    two prefills), or if an output is not finite. The draft directory is
    deleted at the end."""
    import gc
    import shutil
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.models.vlm.speculative import self_draft

    cap = pipe.llava
    lcfg = pipe.cfg.llava
    img = Image.open(sr_path).convert("RGB")
    prompt = gen.llama3_chat_prompt(lcfg.img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))
    with torch.inference_mode():
        emb = gen.embed_multimodal_prompt(
            cap.llama, cap.vision, cap.projector, prompt, [img],
            lambda t: cap.tokenizer.encode(t, add_special_tokens=False),
            cap.image_newline, cap.vision.cfg.image_size)
    sampled = gen.GenerateConfig(max_new_tokens=lcfg.max_new_tokens,
                                 temperature=lcfg.temperature,
                                 do_sample=lcfg.do_sample)
    greedy = dataclasses.replace(sampled, do_sample=False)
    dd = cd / "llava_draft"
    rec: dict = dict(spec_k=SPEC_K, prompt_len=int(emb.shape[0]))
    ids: dict = {}
    try:
        cap.attach_draft(None)  # no draft: the decode_graphs start empty
        rec["vanilla"], ids["vanilla_sampled"] = _spec_run(cap, emb, sampled)
        rec["vanilla_greedy"], ids["vanilla"] = _spec_run(cap, emb, greedy)
        sd = self_draft(cap.llama, SELF_DRAFT_LAYERS)
        rec["self_draft"], _ = _spec_run(cap, emb, sampled, sd, SELF_DRAFT_LAYERS)
        rec["self_draft"].update(_spec_round_ms(cap, sd, int(emb.shape[0])))
        rec["self_draft_greedy"], ids["self"] = _spec_run(
            cap, emb, greedy, sd, SELF_DRAFT_LAYERS)
        # the target as its own draft, sampled with the vanilla run's
        # default draws: the accept branch at full width (a report: bf16
        # 5-row and 1-row sums may part at near-ties)
        layers = cap.llama.cfg.layers
        rec["draft_is_target"], ids["target"] = _spec_run(
            cap, emb, sampled, cap.llama, layers)
        rec["draft_is_target"].update(
            _spec_round_ms(cap, cap.llama, int(emb.shape[0])),
            vs_vanilla_sampled=_greedy_gap(cap, emb, ids["vanilla_sampled"],
                                           ids["target"]))
        # the user's entry point too: caption() with the self-draft attached
        cap.attach_draft(None, spec_k=SPEC_K, self_draft_layers=SELF_DRAFT_LAYERS)
        text = cap.caption(img, lcfg)
        rec["self_draft_caption"] = dict(words=len(text.split()),
                                         rounds=cap.last_stats["rounds"],
                                         accept_rate=cap.last_stats["accept_rate"])
        cap.attach_draft(None)
        dcfg = dataclasses.replace(cap.llama.cfg, layers=DRAFT_LAYERS)
        t0 = time.perf_counter()
        rec["draft_ckpt_bytes"] = _write_draft_dir(dd, dcfg, seed)
        rec["draft_write_s"] = time.perf_counter() - t0
        args = infer.parse_args([
            "--input_img", sr_path, "--ckpt_dir", str(cd), "--quant", "int4",
            "--draft_dir", str(dd), "--seed", str(seed)])
        t0 = time.perf_counter()
        pipe2 = infer.build_pipeline(args)
        pipe2._load_llava()
        cap2 = pipe2.llava
        if cap2 is None:
            raise RuntimeError(f"the captioner of {cd} with --draft_dir {dd} "
                               "did not load")
        torch.cuda.synchronize()
        rec["draft_pipeline_load_s"] = time.perf_counter() - t0
        rec["draft_load_s"] = cap2.load_stats.get("draft_s")
        rec["draft_loaded"] = bool(cap2.draft is not None
                                   and cap2.draft.cfg.layers == DRAFT_LAYERS
                                   and cap2.self_draft_layers == 0)
        rec["draft_ckpt"], _ = _spec_run(cap2, emb, sampled, cap2.draft,
                                         DRAFT_LAYERS)
        rec["draft_ckpt"].update(_spec_round_ms(cap2, cap2.draft, int(emb.shape[0])))
        rec["draft_ckpt_greedy"], ids["ckpt"] = _spec_run(
            cap2, emb, greedy, cap2.draft, DRAFT_LAYERS)
        text2 = cap2.caption(img, lcfg)
        rec["draft_ckpt_caption"] = dict(words=len(text2.split()),
                                         rounds=cap2.last_stats["rounds"])
        rec["greedy_self_vs_vanilla"] = _greedy_gap(cap, emb, ids["vanilla"],
                                                    ids["self"])
        rec["greedy_ckpt_vs_vanilla"] = _greedy_gap(cap, emb, ids["vanilla"],
                                                    ids["ckpt"])
        del pipe2, cap2
    finally:
        shutil.rmtree(dd, ignore_errors=True)
        cap.attach_draft(None)
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("vanilla", "self_draft", "draft_ckpt", "draft_is_target"):
        rec[name]["vanilla_decode_tok_s"] = rec["vanilla"]["decode_tok_s"]
    runs = [v for v in rec.values() if isinstance(v, dict) and "ok" in v]
    rec["launches"] = {c: sum(r[f"{c}_launches"] for r in runs)
                       for c in ("k1", "k2")}
    rec["finite"] = bool(torch.isfinite(emb).all())
    rec["ok"] = bool(all(r["ok"] for r in runs) and len(runs) == 7
                     and rec["draft_loaded"] and rec["finite"]
                     and all(rec[n]["replayed"] for n in (
                         "self_draft", "draft_ckpt", "draft_is_target"))
                     and rec["self_draft"]["k2_per_round"]
                     == k2_per_round(SELF_DRAFT_LAYERS)
                     and rec["draft_ckpt"]["k2_per_round"]
                     == k2_per_round(DRAFT_LAYERS)
                     and rec["draft_is_target"]["k2_per_round"]
                     == k2_per_round(layers)
                     and rec["self_draft_caption"]["rounds"] > 0
                     and rec["draft_ckpt_caption"]["rounds"] > 0)
    _say("spec", **rec)
    return rec


# -------------------------------------------------------------- phase 5t
def _vae_alone(pipe, x, tiles: bool) -> dict:
    """The VAE preparation and the final decode alone on x [1, H, W, 3]
    (NHWC), tiled or whole: seconds and peak memory of each."""
    import torch
    from rsvldm_tpu_torch.pipeline import _nchw
    pipe.cfg.refine.use_tile_vae = tiles
    out = {}
    with torch.inference_mode():
        for name in ("vae_prep", "decode"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if name == "vae_prep":
                _, x_stage1, z = pipe._vae_prep(_nchw(x))
            else:
                y = pipe._decode(z)
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out[f"{name}_peak_above_gib"] = (torch.cuda.max_memory_allocated()
                                             - base) / 2**30
        out["finite"] = bool(torch.isfinite(x_stage1).all() and torch.isfinite(y).all())
        out["shapes"] = [list(x_stage1.shape), list(z.shape), list(y.shape)]
    del x_stage1, z, y
    torch.cuda.empty_cache()
    return out


def phase_tiled(seed: int, pipe, sr_path: str, caption: str):
    """The tiled VAE at full width on the path's pipeline: the 1024^2
    refinement of the path's Stage-1 image (the path's caption, the same
    seed's draws) without and with use_tile_vae at the default 512 / 64
    tile sizes (4 encoder tiles of 576^2, 4 decoder tiles of 86^2
    latent): vae_prep and decode seconds and the whole refinement's peak
    memory, and the VAE alone (seconds, peak) each way; the mean and max
    uint8 difference between the two images, both resized back to the
    Stage-1 image's size as process() writes them (a report: halos and
    pooled statistics make them differ). Then the tiled VAE preparation and
    decode alone at 2048^2 (16 tiles each): seconds and peak; the whole
    VAE is not run there, its mid-attention scores would be 65536^2 fp32
    (the reckoned bytes are printed). Fails unless each refinement
    launches K1 106 times a denoiser miss and 58 a hit (Stage 2b; the
    VAE's attention is plain) and K2 never."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.pipeline import TorchNoise

    r = pipe.cfg.refine
    img = Image.open(sr_path).convert("RGB")
    rec: dict = dict(encoder_tile=r.encoder_tile_size,
                     decoder_tile=r.decoder_tile_size)
    outs = {}
    try:
        for tiles in (False, True):
            name = "tiled" if tiles else "whole"
            r.use_tile_vae = tiles
            pipe.noise = TorchNoise(seed, pipe.device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            outs[name] = np.asarray(pipe.run_refinement(img, caption,
                                                        use_bucket=False), np.int16)
            torch.cuda.synchronize()
            n, dfb = _counts(), pipe.last_dfb
            _reset_counts()
            rec[name] = dict(refine_s=time.perf_counter() - t0,
                             k1_launches=n["k1"], k2_launches=n["k2"],
                             expected_k1=(dfb["steps"] - dfb["hits"]) * K1_PER_MISS
                             + dfb["hits"] * K1_PER_HIT,
                             vae_prep_s=pipe.timings["vae_prep"],
                             decode_s=pipe.timings["decode"],
                             sampling_s=pipe.timings["sampling"],
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             finite=pipe.outputs_finite["refined"],
                             shape=list(outs[name].shape),
                             tiles_used=pipe._use_tiles((1024, 1024)))
        d = np.abs(outs["whole"] - outs["tiled"])
        rec["tiled_vs_whole_uint8"] = dict(mean_abs=float(d.mean()),
                                           max_abs=int(d.max()))
        g = torch.Generator(device=pipe.device).manual_seed(seed + 9)
        for side in (1024, 2048):
            x = torch.rand((1, side, side, 3), generator=g,
                           device=pipe.device) * 2 - 1
            for tiles in ((False, True) if side == 1024 else (True,)):
                rec[f"vae_alone_{side}_{'tiled' if tiles else 'whole'}"] = \
                    _vae_alone(pipe, x, tiles)
            del x
        lat = (2048 // 8) ** 2
        rec["whole_2048_mid_attention_scores_bytes"] = lat * lat * 4
    finally:
        r.use_tile_vae = False
        torch.cuda.empty_cache()
    alone = [v for k, v in rec.items() if k.startswith("vae_alone")]
    rec["launches"] = {c: rec["whole"][f"{c}_launches"] + rec["tiled"][f"{c}_launches"]
                       for c in ("k1", "k2")}
    # the refined image comes back at the Stage-1 image's size
    rec["ok"] = bool(rec["whole"]["finite"] and rec["tiled"]["finite"]
                     and all(rec[n]["k1_launches"] == rec[n]["expected_k1"] > 0
                             and rec[n]["k2_launches"] == 0
                             for n in ("whole", "tiled"))
                     and rec["tiled"]["tiles_used"]
                     and not rec["whole"]["tiles_used"]
                     and rec["tiled"]["shape"] == rec["whole"]["shape"]
                     == [img.size[1], img.size[0], 3]
                     and all(a["finite"] for a in alone)
                     and rec["vae_alone_2048_tiled"]["shapes"][2]
                     == [1, 3, 2048, 2048])
    _say("tiled", **rec)
    return rec


# -------------------------------------------------------------- phase 5b
FOLDER_TILES = (28, 28, 28, 32, 28, 28, 28, 28)  # LR tile sides: 7 + 1


def _batched_graphs_vs_direct(pipe, llama, seed: int, rows: int = 8,
                              steps: int = 16, sr3_steps: int = 10) -> dict:
    """Graph replay against direct calls at folder width: `steps` decode
    steps of a B = `rows` loop state (a seeded cache, ragged positions,
    T = 0.2 Gumbel draws), once through a StepRunner (direct, capture,
    replays) and once called directly from the same state: the same ids
    and K2 launches; then `sr3_steps` steps of the batched SR3 loop at 7 x
    224^2, replayed and direct."""
    import copy
    import torch
    from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion,
                                                       sr3_sample)
    from rsvldm_tpu_torch.models.vlm import generate as gen
    from rsvldm_tpu_torch.ops.quant import int4_matmul
    from rsvldm_tpu_torch.utils.graphs import StepRunner
    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    cfg = gen.GenerateConfig(max_new_tokens=steps + 1)
    st0 = gen._decode_state(llama, cfg, 1408, dev, rows)
    for t in (st0.cache.k, st0.cache.v):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    st0.pos.copy_(torch.arange(1300, 1300 + 12 * rows, 12, device=dev))
    st0.tok.copy_(torch.randint(0, 128000, (rows, 1), generator=g, device=dev))
    st0.noise.copy_(gen.gumbel_noise(llama.cfg.vocab_size, g, rows)(0)
                    .expand_as(st0.noise))
    st0.noise.add_(torch.randn(st0.noise.shape, generator=g, device=dev))
    st0.temp.fill_(0.2)
    ids, k2 = {}, {}
    with torch.inference_mode():
        for graphs in (True, False):
            st = copy.copy(st0)
            for f in ("tok", "pos", "idx", "done", "toks"):
                setattr(st, f, getattr(st0, f).clone())
            st.cache = gen.KVCache(st0.cache.k.clone(), st0.cache.v.clone())
            runner = StepRunner(lambda: gen.decode_step(llama, st, None), graphs)
            before = int4_matmul.launches
            for _ in range(steps):
                runner()
            torch.cuda.synchronize()
            k2[graphs] = int4_matmul.launches - before
            ids[graphs] = st.toks.cpu()
            del runner, st
    rec = dict(decode=dict(rows=rows, steps=steps, ids=ids[True][1:4].tolist(),
                           k2_launches=k2[True],
                           ok=bool(torch.equal(ids[True], ids[False])
                                   and k2[True] == k2[False]
                                   == steps * K2_PER_STEP)))
    s1 = pipe.cfg.stage1
    diff = SR3Diffusion.from_schedule(s1.schedule, sr3_steps, s1.linear_start,
                                      s1.linear_end)
    cond = torch.randn((7, 224, 224, 3), generator=g, device=dev).clamp(-1, 1)
    noise = torch.randn((sr3_steps + 1, 7, 224, 224, 3), generator=g,
                        device=dev)
    out = {m: sr3_sample(diff, pipe.sr3, cond, noise, graphs=m)
           for m in (True, False)}
    rec["sr3_batch7"] = dict(steps=sr3_steps, **_same(out[True], out[False]))
    rec["ok"] = rec["decode"]["ok"] and rec["sr3_batch7"]["ok"]
    return rec


def phase_folder(seed: int, cd: Path, process_s: float | None,
                 profile: bool = False):
    """Folder mode at full width, as a user runs it: the processor built
    by the folder CLI's own construction (infer_dir.build_processor,
    --quant int4) from the checkpoint directory phase `path` wrote, then
    ImageBatchProcessor.run() over 8 seeded LR tiles (seven 28^2 and one
    32^2: Stage-1 groups of 7 at 224^2 and 1 at 256^2; one batched int4
    caption of 8, 256 tokens at T = 0.2; all refine at 1024^2, two
    batched RestoreEDM loops of 4, the second replaying the first's kept
    graphs). Every status must be ok, no fallback taken, all 16 PNGs
    written, finite and not flat, the K1 and K2 launches those of the
    batches run; then graph replay against direct calls at this width."""
    import gc
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch import infer_dir

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_folder_"))
    (work / "lr").mkdir()
    rng = np.random.default_rng(seed + 5)
    for i, side in enumerate(FOLDER_TILES):
        Image.fromarray((rng.random((side, side, 3)) * 255).astype(np.uint8)
                        ).save(work / "lr" / f"tile_{i}.png")
    gc.collect()
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated() / 2**30
    args = infer_dir.parse_args([
        "--image_dir", str(work / "lr"), "--save_dir", str(work / "out"),
        "--seed", str(seed), "--ckpt_dir", str(cd), "--quant", "int4"])
    t0 = time.perf_counter()
    proc = infer_dir.build_processor(args)
    proc.pipe.ensure_stage2()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = proc.pipe
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    results = proc.run()
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30

    n = len(FOLDER_TILES)
    pngs, pngs_ok = {}, True
    for sub, pat in (("sr3_output", "sr3_tile_{}.png"),
                     ("output", "tile_{}_final_0.png")):
        for i, side in enumerate(FOLDER_TILES):
            f = work / "out" / sub / pat.format(i)
            a = np.asarray(Image.open(f)) if f.exists() else None
            pngs[f"{sub}/{f.name}"] = None if a is None else dict(
                shape=list(a.shape), std=round(float(a.std()), 3))
            pngs_ok = pngs_ok and a is not None and a.std() > 0 \
                and a.shape == (8 * side, 8 * side, 3)
    caps = proc.caption_batches
    chunks = proc.refine_chunks
    k1_want = K1_PER_CAPTION * len(caps) + sum(
        (c["steps"] - c["hits"]) * K1_PER_MISS + c["hits"] * K1_PER_HIT
        for c in chunks)
    # the decode steps, and the prefill's lm_head on the rows' last positions
    k2_want = sum(K2_PER_STEP * c["decode_steps"] + 1 for c in caps)
    decode = [dict(rows=c["rows"], prompt_lens=c["prompt_lens"],
                   padded_len=c["padded_len"], prefill_s=c["prefill_s"],
                   decode_s=c["decode_s"], decode_steps=c["decode_steps"],
                   tok_s_all_rows=c["rows"] * c["decode_steps"] / c["decode_s"],
                   tok_s_per_row=c["decode_steps"] / c["decode_s"],
                   capture_s=c["capture_s"], seconds=c["seconds"])
              for c in caps if c.get("decode_s")]
    kept = [k[0] if isinstance(k[0], str) else "restore_edm"
            for k in pipe.loop_graphs]
    cap0, cap1 = ([c["capture_s"] for c in chunks] + [{}, {}])[:2]
    rec = dict(
        tiles=list(FOLDER_TILES), init_s=init_s, statuses=dict(results),
        fallbacks=proc.fallbacks, timings=proc.timings,
        folder_s=proc.timings["folder"],
        s_per_image=proc.timings["folder"] / n,
        path_process_s=process_s,
        stage1_groups=pipe.stage1_groups, captions=decode,
        refine_chunks=chunks, launches=counts,
        expected_launches=dict(k1=k1_want, k2=k2_want),
        peak_mem_gib=peak, reserved_gib=reserved,
        held_before_gib=held_before,
        kept_loops=kept,
        kept_decode_states=len(pipe.llava.decode_graphs) if pipe.llava else 0,
        pngs=pngs, outputs_finite=pipe.outputs_finite)
    ok = bool(all(s == "ok" for _, s in results) and len(results) == n
              and not proc.fallbacks and pngs_ok
              and all(pipe.outputs_finite.values())
              and [g["n"] for g in pipe.stage1_groups] == [7, 1]
              and [c["n"] for c in caps] == [8]
              and [c["n"] for c in chunks] == [4, 4]
              # the second chunk replays every graph the first captured
              and cap0.get("sampling_first", 0) > 0
              and all(cap1.get(k) == 0 for k, v in cap0.items() if v > 0)
              and counts["k1"] == k1_want > 0 and counts["k2"] == k2_want > 0)
    if profile and pipe.llava is not None:
        from rsvldm_tpu_torch.models.vlm import generate as gen
        llama = pipe.llava.llama
        st = gen._decode_state(llama, gen.GenerateConfig(max_new_tokens=128),
                               1408, pipe.device, rows=8)
        st.pos.fill_(1300)
        rec["profile"] = _profile_steps(
            {"decode_b8": lambda: gen.decode_step(llama, st, None)},
            {"decode_b8": "int4_decode_kernel"}, 10)
        del st
    rec["graphs"] = _batched_graphs_vs_direct(pipe, pipe.llava.llama, seed)
    rec["ok"] = bool(ok and rec["graphs"]["ok"])
    _say("folder", **rec)
    del proc, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------- phase 4b, 5c
def phase_train_reference(seed: int, quant: str, seq: int = 1024):
    """One loss and its adapter gradients at a small width with 128-wide
    heads and {seq} tokens (so K1 and the backward run), on the card in bf16
    with remat against the CPU in fp32 without: the same weights (rounded
    to bf16 so both quantize the same values to the same bytes), adapters
    (nonzero B) and batch. Passes on the loss's relative error and every
    adapter leaf's gradient cosine."""
    import torch
    from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                                   quantize_llama_)
    from rsvldm_tpu_torch.training import vlm_trainer as vt
    from rsvldm_tpu_torch.utils.weights import seeded_init_

    lcfg = LlamaConfig(vocab_size=1024, dim=256, layers=2, heads=2,
                       kv_heads=1, ffn_dim=512)
    dense = seeded_init_(LlamaModel(lcfg), "llama", torch.device("cpu"))
    sd = {k: v.to(torch.bfloat16).float() for k, v in dense.state_dict().items()}
    gen = torch.Generator().manual_seed(seed + 5)
    b = 2
    emb = (torch.randn((b, seq, lcfg.dim), generator=gen) * 0.5).to(
        torch.bfloat16).float()
    labels = torch.randint(0, lcfg.vocab_size, (b, seq), generator=gen)
    labels[:, : seq // 2] = vt.IGNORE_INDEX
    cfg = vt.LoraConfig(r=16, alpha=16)
    grads, losses, models = {}, {}, {}
    for dev in ("cpu", "cuda"):
        m = LlamaModel(dataclasses.replace(lcfg, remat=dev == "cuda"))
        m.load_state_dict(sd)
        m = m.to(dev, torch.float32 if dev == "cpu" else torch.bfloat16)
        models[dev] = quantize_llama_(m.requires_grad_(False), quant)
    lora0 = vt.init_lora(models["cpu"], cfg, torch.Generator().manual_seed(seed))
    for ab in lora0.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.01
    same_bytes = all(torch.equal(v.cpu(), models["cpu"].state_dict()[k])
                     for k, v in models["cuda"].state_dict().items()
                     if v.dtype == torch.int8)
    for dev in ("cpu", "cuda"):
        lora = {p: {n: t.to(dev).requires_grad_() for n, t in ab.items()}
                for p, ab in lora0.items()}
        _reset_counts()
        loss = vt.vlm_loss(models[dev], lora, cfg,
                           emb.to(dev, models[dev].dtype), labels.to(dev))
        leaves = [(f"{p}.{n}", t) for p, ab in lora.items()
                  for n, t in ab.items()]
        g = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
        grads[dev] = {name: x.float().cpu() for (name, _), x in zip(leaves, g)}
        losses[dev] = float(loss.detach())
        launches = _counts()
    cos = {k: float(torch.nn.functional.cosine_similarity(
        grads["cpu"][k].flatten(), grads["cuda"][k].flatten(), dim=0))
        for k in grads["cpu"]}
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    rec = dict(quant=quant, seq=seq, batch=b, layers=lcfg.layers,
               head_dim=lcfg.head_dim, loss_cpu=losses["cpu"],
               loss_card=losses["cuda"], loss_rel_err=loss_rel,
               grad_cos_min=min(cos.values()),
               grad_cos_min_leaf=min(cos, key=cos.get),
               same_quantized_bytes=same_bytes, card_launches=launches,
               tol=f"loss rel err <= {TRAIN_LOSS_RTOL}, every leaf's "
                   f"gradient cosine >= {TRAIN_COS_MIN}")
    rec["ok"] = bool(same_bytes and loss_rel <= TRAIN_LOSS_RTOL
                     and min(cos.values()) >= TRAIN_COS_MIN
                     and launches["k1"] == 2 * lcfg.layers
                     and launches["bwd"] == lcfg.layers)
    _reset_counts()
    _say("train_reference", **rec)
    return rec


def _train_data(work: Path, cap, tok, seed: int, n: int, width: int):
    """n anyres image records (seeded 224^2 PNGs) whose answers make the
    spliced sequences width-60 .. width-1 tokens long, so every batch pads
    to `width`. Returns (image tokens per record, the record lengths)."""
    import numpy as np
    import torch
    from PIL import Image
    from rsvldm_tpu_torch.models.vlm.generate import anyres_image_features
    from rsvldm_tpu_torch.training.vlm_data import (normalize_multimodal,
                                                    preprocess_llama3)
    rng = np.random.default_rng(seed + 3)
    (work / "imgs").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = Image.fromarray((rng.random((224, 224, 3)) * 255).astype(np.uint8))
        img.save(work / "imgs" / f"tile_{i}.png")
    with torch.no_grad():
        n_img = anyres_image_features(cap.vision, cap.projector, img,
                                      cap.image_newline,
                                      cap.vision.cfg.image_size).shape[0]
    question = "<image>\nDescribe the remote sensing image in detail."
    conv = lambda ans: [{"from": "human", "value": question},
                        {"from": "gpt", "value": ans}]
    # spliced length with a one-word answer: the <image> id becomes n_img rows
    base = len(preprocess_llama3(normalize_multimodal(conv("w")),
                                 tok.encode)[0]) - 1 + n_img
    recs, lengths = [], []
    for i in range(n):
        lengths.append(width - 60 + (i * 7) % 60)
        words = lengths[-1] - base + 1
        recs.append({"id": i, "image": f"tile_{i}.png",
                     "conversations": conv(" ".join(
                         f"a{(i * 31 + j) % 977}" for j in range(words)))})
    (work / "train.json").write_text(json.dumps(recs))
    return n_img, lengths


def _device_kernels(prof):
    """(device ms by kernel name, total device ms) from a torch.profiler
    run: device-side kernel events only (a CPU op's self device time
    repeats its kernels')."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == DeviceType.CUDA]
    return rows, sum(t for _, t, _ in rows)


def phase_train(seed: int, steps: int = 4, batch: int = 4, width: int = 1536,
                profile: bool = False):
    """The port's train_vlm loop at full width: a seeded LLaVA-NeXT-8B
    captioner (CLIP-L/336, mlp2x_gelu, Llama-3-8B) with an int8 decoder,
    LoRA r=16 alpha=16 on the seven projections, AdamW lr 2e-4, gradient
    checkpointing, anyres image records, batch 4 padded to `width` tokens.
    Launch counts are reset just before the loop and read just after."""
    import torch
    from rsvldm_tpu_torch import train_vlm
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    t0 = time.perf_counter()
    tok = StandInTokenizer()
    cap = LlavaCaptioner.seeded(tokenizer=tok, quant="int8", device="cuda",
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_img, lengths = _train_data(work, cap, tok, seed, steps * batch, width)
    args = train_vlm.parse_args([
        "--data_path", str(work / "train.json"),
        "--image_folder", str(work / "imgs"), "--output_dir", str(work / "out"),
        "--image_aspect_ratio", "anyres", "--bits", "8", "--lora_r", "16",
        "--lora_alpha", "16", "--lr", "2e-4", "--batch_size", str(batch),
        "--steps", str(steps), "--seed", str(seed), "--num_workers", "2"])
    digest = _sd_digest(cap.llama.state_dict())
    per_step = []
    last = dict(_counts())
    prof = []

    def on_step(r):
        now = _counts()
        r = dict(r, tokens_per_s=r["batch"] * r["width"] / r["seconds"],
                 launches={k: now[k] - last[k] for k in now})
        last.update(now)
        per_step.append(r)
        _say("train", **r)
        if profile and r["step"] == steps - 1:
            # the last step (its batch's preparation included) is traced
            from torch.profiler import ProfilerActivity
            prof.append(torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            prof[0].__enter__()

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    last.update(_counts())
    t0 = time.perf_counter()
    res, trainer = train_vlm.train(args, cap, encode=tok.encode,
                                   on_step=on_step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = _counts()
    if prof:
        prof[0].__exit__(None, None, None)
        rows, dev_ms = _device_kernels(prof[0])
        share = lambda name: sum(t for k, t, _ in rows if name in k)
        hand = {k: share(n) for k, n in (
            ("k1", "flash_fwd_kernel"), ("bwd", "flash_bwd_kernel"),
            ("bwd_prep", "flash_bwd_prep_kernel"))}
        _say("profile", step="train", device_ms=dev_ms,
             unprofiled_step_ms=per_step[-2]["seconds"] * 1e3,
             hand_ms=hand,
             hand_share_of_device={k: v / dev_ms for k, v in hand.items()},
             kernel_launches=sum(c for _, _, c in rows),
             top_kernels=[[k[:80], round(t, 3), c] for k, t, c in
                          sorted(rows, key=lambda r: -r[1])[:12]])
    moved = all(float(ab["b"].detach().abs().max()) > 0
                for ab in trainer.lora.values())
    unchanged = _sd_digest(cap.llama.state_dict()) == digest
    rec = dict(init_s=init_s, loop_s=loop_s, steps=res["steps"],
               batch=batch, width=width, image_tokens=n_img,
               record_tokens=[min(lengths), max(lengths)],
               losses=[r["loss"] for r in per_step],
               step_s=[r["seconds"] for r in per_step],
               tokens_per_s=[r["tokens_per_s"] for r in per_step],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, adapters=len(trainer.lora),
               adapters_moved=moved, base_unchanged=unchanged,
               base_digest=digest)
    rec["ok"] = bool(
        res["steps"] == steps
        and all(r["width"] == width for r in per_step)
        and all(r["launches"]["k1"] == 2 * 32 and r["launches"]["bwd"] == 32
                for r in per_step)
        and launches["k1"] == 64 * steps
        and launches["bwd"] == 32 * steps
        and all(math.isfinite(x) for x in rec["losses"])
        and moved and unchanged)
    _say("train", **{k: v for k, v in rec.items() if k != "losses"},
         losses=rec["losses"])
    del trainer, cap
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------- phase 6
def phase_profile(pipe, iters: int = 10):
    """The loops' steps as process() runs them, each replayed from a CUDA
    graph (utils/graphs.StepRunner): one int4 decode step of the caption
    (position 1300 of a 1536-slot cache), one SR3 ancestral step (224^2),
    one cache-miss step (GLVControl + UNet input blocks + rest + CFG) and
    one cache-hit step (GLVControl + input blocks) of the 128^2-latent
    RestoreEDM loop, CFG batch 2: wall time per replay and per direct call,
    device time by kernel under torch.profiler, K1's or K2's share, and the
    device's idle share while replaying."""
    import torch
    from rsvldm_tpu_torch.diffusion.guidance import apply_cfg
    from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
    from rsvldm_tpu_torch.models.sr3.diffusion import ancestral_step
    from rsvldm_tpu_torch.models.vlm import generate as gen

    dev, cfg = pipe.device, pipe.sdxl_cfg
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s, dt=torch.float32: torch.randn(s, generator=g, device=dev,
                                                   dtype=dt)
    cond = dict(crossattn=rnd(2, 77, cfg.context_dim, dt=pipe.dtype),
                vector=rnd(2, cfg.adm_in_channels), control=rnd(2, 4, 128, 128))
    x, sigma = rnd(2, 4, 128, 128), torch.full((2,), 5.0, device=dev)
    cs = torch.ones((), device=dev)
    scale = torch.full((), 7.5, device=dev)
    den = ControlDenoiser(unet=pipe.unet, control_net=pipe.control)
    llama = pipe.llava.llama
    st = gen._decode_state(llama, gen.GenerateConfig(max_new_tokens=128),
                           1408, dev)
    st.pos.fill_(1300)
    sr3_step, _ = ancestral_step(pipe.sr3_diff, pipe.sr3,
                                 rnd(1, 224, 224, 3).clamp(-1, 1),
                                 rnd(pipe.sr3_diff.buffers.num_timesteps + 1,
                                     1, 224, 224, 3))
    steps = {"decode": lambda: gen.decode_step(llama, st, None),
             "sr3": sr3_step,
             "miss": lambda: apply_cfg(den.rest(den.first(x, sigma, cond),
                                                cond, cs), scale),
             "hit": lambda: den.first(x, sigma, cond).h}
    hand_of = {"decode": "int4_decode_kernel", "sr3": None,
               "miss": "flash_fwd_kernel", "hit": "flash_fwd_kernel"}
    return _profile_steps(steps, hand_of, iters)


def _profile_steps(steps: dict, hand_of: dict, iters: int) -> dict:
    """Each step function of `steps` replayed from a CUDA graph: wall time
    per replay and per direct call, device time by kernel under
    torch.profiler, the share of its hand kernel (`hand_of`), the share
    of bf16 -> fp32 copies, and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsvldm_tpu_torch.utils.graphs import StepRunner
    out = {}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    with torch.inference_mode():
        for name, fn in steps.items():
            runner = StepRunner(fn, True)
            runner()  # direct
            runner()  # capture, replay
            direct_ms = wall_ms(fn)
            replay_ms = wall_ms(runner)
            event_ms = _time_ms(runner, iters, warmup=0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runner()
                torch.cuda.synchronize()
            kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0
                       and e.device_type == DeviceType.CUDA]
            dev_ms = sum(t for _, t, _ in kernels)
            copy_ms = sum(t for k, t, _ in kernels if "copy_kernel" in k)
            mine = hand_of[name]
            hand = [(t, c) for k, t, c in kernels if mine and mine in k]
            hand_ms = sum(t for t, _ in hand)
            out[name] = dict(
                replay_wall_ms=round(replay_ms, 3),
                direct_wall_ms=round(direct_ms, 3),
                replay_event_ms=round(event_ms, 3),
                device_ms=round(dev_ms, 3),
                device_idle_share=round(1 - dev_ms / replay_ms, 4),
                capture_s=round(runner.capture_s, 3), hand_kernel=mine,
                hand_ms=round(hand_ms, 3),
                hand_launches=sum(c for _, c in hand),
                hand_share_of_device=round(hand_ms / dev_ms, 4)
                if dev_ms else None,
                copy_ms=round(copy_ms, 3),
                copy_share_of_device=round(copy_ms / dev_ms, 4)
                if dev_ms else None,
                kernel_launches=sum(c for _, _, c in kernels),
                top_kernels=[[k[:80], round(t, 3), c] for k, t, c in
                             sorted(kernels, key=lambda r: -r[1])[:10]])
            _say("profile", step=name, **out[name])
            del runner
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-path", action="store_true",
                    help="stop after the kernel checks (no pipeline run)")
    ap.add_argument("--profile", action="store_true",
                    help="after the path, profile a replayed decode step, "
                         "SR3 step, cache-miss and cache-hit denoising step, "
                         "and the last training step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "rsvldm_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the rsvldm_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    smi = phase_device()
    phase_build()
    cases, k2, bwd = phase_kernels()
    ok = all(c["ok"] for c in cases + k2 + bwd)
    ok = phase_reference(SEED)["ok"] and ok
    for quant in ("int4", "int8"):
        ok = phase_caption_reference(SEED, quant)["ok"] and ok
    ok = phase_batch_caption_reference(SEED)["ok"] and ok
    ok = phase_spec_reference(SEED)["ok"] and ok
    ok = phase_tiled_reference(SEED)["ok"] and ok
    for quant in ("int8", "int4"):
        ok = phase_train_reference(SEED, quant)["ok"] and ok
    path = folder = train = spec = tiled = None
    if not args.skip_path:
        import shutil
        path, pipe, cd = phase_path(SEED)
        ok = ok and path["ok"]
        if cd is not None:
            try:
                if args.profile and pipe is not None:
                    phase_profile(pipe)
                if pipe is not None:
                    spec = phase_spec(SEED, pipe, cd, path["sr3_path"])
                    ok = ok and spec["ok"]
                    tiled = phase_tiled(SEED, pipe, path["sr3_path"],
                                        pipe.last_caption)
                    ok = tiled["ok"] and ok
                del pipe  # its weights and kept graphs, before the folder's
                folder = phase_folder(SEED, cd, path.get("process_s"),
                                      profile=args.profile)
                ok = ok and folder["ok"]
            finally:
                shutil.rmtree(cd, ignore_errors=True)
        else:
            ok = False
        train = phase_train(SEED, profile=args.profile)
        ok = ok and train["ok"]
    by_path = {"process": path.get("launches", {}) if path else {},
               "spec": spec["launches"] if spec else {},
               "tiled": tiled["launches"] if tiled else {},
               "folder": folder["launches"] if folder else {},
               "train": train["launches"] if train else {}}

    def launches(k):
        # None where a path's run did not read this kernel's count
        return {p: c.get(k) for p, c in by_path.items()}

    def entry(name, source, replaces, k, rows, keys):
        head = rows[0]
        n = launches(k)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(v for v in n.values() if v is not None),
                "launches_by_path": n,
                "max_abs_err": max(c["max_abs_err"] for c in rows
                                   if "max_abs_err" in c),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "shapes": [{k: c.get(k) for k in keys} for c in rows
                           if "plain_ms" in c],
                "card": smi}

    report = {"kernels": [
        entry("flash_fwd", "rsvldm_tpu_torch/csrc/flash_fwd.cu",
              "rsvldm_tpu/ops/flash_attention.py:67", "k1", cases,
              ("case", "shape", "causal", "ms", "wrapper_ms", "plain_ms",
               "bound_ms", "library_ms", "tflops", "max_abs_err")),
        entry("int4_decode", "rsvldm_tpu_torch/csrc/int4_decode.cu",
              "rsvldm_tpu/ops/quant.py:185", "k2", k2,
              ("case", "shape", "ms", "wrapper_ms", "plain_ms", "bound_ms",
               "library", "library_ms", "gbps", "max_abs_err",
               "max_err_over_tol")),
        # one fused kernel for the TPU's dK/dV and dQ kernels
        entry("flash_bwd", "rsvldm_tpu_torch/csrc/flash_bwd.cu",
              "rsvldm_tpu/ops/flash_attention.py:326 + "
              "rsvldm_tpu/ops/flash_attention.py:376", "bwd", bwd,
              ("case", "shape", "causal", "ms", "whole_ms", "wrapper_ms",
               "plain_ms", "bound_ms", "library_ms", "library_wrapper_ms",
               "library_op", "tflops", "max_abs_err"))]}
    print(json.dumps(report), flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if args.skip_path:
        print("chip_smoke: --skip-path given, no result line", file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
