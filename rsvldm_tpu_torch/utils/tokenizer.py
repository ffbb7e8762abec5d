"""CLIP BPE tokenizer: the port's copy of rsvldm_tpu/utils/tokenizer.py
(JAX's ids are the parity target), with no torch and no network.

It stands in for the reference's HF CLIPTokenizer and open_clip.tokenize
(sgm/modules/encoders/modules.py:453,559). Assets (vocab/merges) are loaded
from the local checkpoint directory:

  * open_clip format: bpe_simple_vocab_16e6.txt.gz  (merges; vocab derived)
  * HF format:        vocab.json + merges.txt

Padding conventions differ between the two towers and are preserved:
CLIP-L (HF) pads with the EOT id 49407, OpenCLIP pads with 0. The pooled
embedding uses argmax(token_id) so the EOT position is identical either way.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re

import numpy as np

SOT = 49406
EOT = 49407
CONTEXT = 77


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 reversible byte<->unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    """CLIP BPE with lowercase cleaning and </w> word-end markers."""

    # approximation of the \p{L}/\p{N} pattern (prompts are ASCII/English)
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE | re.UNICODE)

    def __init__(self, merges: list[tuple[str, str]],
                 vocab: dict[str, int] | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if vocab is None:
            base = list(bytes_to_unicode().values())
            toks = base + [v + "</w>" for v in base]
            toks += ["".join(m) for m in merges]
            toks += ["<|startoftext|>", "<|endoftext|>"]
            vocab = {t: i for i, t in enumerate(toks)}
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder.get("<|startoftext|>", SOT)
        self.eot = self.encoder.get("<|endoftext|>", EOT)

    # --- constructors ---
    @classmethod
    def from_openclip_bpe(cls, path: str) -> "CLIPTokenizer":
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        return cls(merges)

    @classmethod
    def from_hf_files(cls, vocab_json: str, merges_txt: str) -> "CLIPTokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines
                  if m and not m.startswith("#version") and len(m.split()) == 2]
        return cls(merges, vocab)

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        oc = os.path.join(path, "bpe_simple_vocab_16e6.txt.gz")
        if os.path.exists(oc):
            return cls.from_openclip_bpe(oc)
        vj = os.path.join(path, "vocab.json")
        mt = os.path.join(path, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            return cls.from_hf_files(vj, mt)
        raise FileNotFoundError(f"no CLIP tokenizer assets under {path}")

    # --- BPE core ---
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        text = _clean(text).lower()
        for token in self._PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self.bpe(token).split(" "):
                if bpe_token in self.encoder:
                    ids.append(self.encoder[bpe_token])
        return ids

    def __call__(self, texts, context_length: int = CONTEXT,
                 pad_id: int | None = 0) -> np.ndarray:
        """Tokenize to [N, context] int32 with SOT/EOT framing.

        pad_id=0 (open_clip convention) or self.eot (HF convention)."""
        if isinstance(texts, str):
            texts = [texts]
        pad = self.eot if pad_id is None else pad_id
        out = np.full((len(texts), context_length), pad, dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [self.sot] + self.encode(t)[:context_length - 2] + [self.eot]
            out[i, :len(toks)] = toks
        return out
