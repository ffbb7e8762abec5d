"""The Llama-3 tokenizer from <ckpt_dir>/llava/tokenizer.json, without the
`tokenizers` or `transformers` packages (the JAX captioner reads it through
transformers.AutoTokenizer, rsvldm_tpu/models/vlm/captioner.py:222-224).

What it reads, in encode order:
  1. `added_tokens`, split out of the raw text first (longest match at the
     leftmost position), so that the chat template's `<|begin_of_text|>`,
     `<|start_header_id|>`, `<|eot_id|>` ... map to their ids even with
     add_special_tokens=False;
  2. the `Split` pre-tokenizer (behaviour "Isolated": matches and the text
     between them are both pieces) in the stdlib `re`. `re` has no
     \\p{L} / \\p{N}; they become explicit classes built from
     unicodedata (letters: categories L*, numbers: N*, which takes in the
     Nl / No characters such as `½`, `²` and `Ⅻ` that `\\d` misses), and
     \\s / \\S become the Unicode White_Space set (stdlib `\\s` also takes
     U+001C-U+001F);
  3. the `ByteLevel` map of each piece's UTF-8 bytes to printable chars;
  4. the `BPE` model: with `ignore_merges`, a piece that is in the
     vocabulary whole is one id; otherwise merges by rank, lowest first.
`add_special_tokens=True` applies the `post_processor`'s TemplateProcessing
(Llama-3: BOS before the text). `decode` drops special added tokens when
asked, reverses the byte map (invalid UTF-8 becomes U+FFFD) and applies
transformers' clean-up of spaces before punctuation when
tokenizer_config.json asks for it.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List

from ...utils.tokenizer import bytes_to_unicode

# the Unicode White_Space property (Oniguruma's \s)
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


def _esc(c: str) -> str:
    return f"\\U{ord(c):08x}"


@functools.lru_cache(maxsize=None)
def unicode_class(major: str) -> str:
    """The body of a character class (ranges) holding every code point
    whose general category starts with `major` ("L" or "N")."""
    ranges, start, prev = [], None, None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return "".join(_esc(chr(a)) if a == b else f"{_esc(chr(a))}-{_esc(chr(b))}"
                   for a, b in ranges)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern with \\p{L}, \\p{N}, \\s and \\S -> the same
    pattern for the stdlib `re`."""
    classes = {"L": None, "N": None}
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            nxt = pattern[i + 1]
            if nxt == "p":
                m = re.match(r"\\p\{(\w+)\}", pattern[i:])
                if not m or m.group(1) not in classes:
                    raise NotImplementedError(
                        f"tokenizer.json: unsupported class {pattern[i:i + 8]!r}")
                body = unicode_class(m.group(1))
                out.append(body if in_class else f"[{body}]")
                i += m.end()
                continue
            if nxt == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
            elif nxt == "S":
                if in_class:
                    raise NotImplementedError("tokenizer.json: \\S inside a class")
                out.append(f"[^{_WHITE_SPACE}]")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":  # a literal ] first in a class
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _clean_up_tokenization(text: str) -> str:
    """transformers' PreTrainedTokenizerBase.clean_up_tokenization."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _steps(node: dict | None, key: str) -> list:
    """A component of tokenizer.json as a list of steps (a `Sequence`
    unrolled)."""
    if node is None:
        return []
    if node.get("type") == "Sequence":
        return node[key]
    return [node]


class Llama3Tokenizer:
    """encode(text, add_special_tokens=False) / decode(ids,
    skip_special_tokens=True), as transformers' fast tokenizer gives them
    for a tokenizer.json of Llama-3's kind (ByteLevel BPE)."""

    def __init__(self, spec: dict, clean_up_spaces: bool = False):
        model = spec["model"]
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer.json: model {model.get('type')}")
        if spec.get("normalizer") is not None:
            raise NotImplementedError("tokenizer.json: a normalizer is not supported")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.split = None
        for step in _steps(spec.get("pre_tokenizer"), "pretokenizers"):
            kind = step.get("type")
            if kind == "Split":
                if step.get("behavior") != "Isolated" or step.get("invert"):
                    raise NotImplementedError(f"tokenizer.json: Split {step}")
                self.split = re.compile(translate_pattern(step["pattern"]["Regex"]))
            elif kind != "ByteLevel" or step.get("use_regex") or \
                    step.get("add_prefix_space"):
                raise NotImplementedError(f"tokenizer.json: pre-tokenizer {step}")
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", [])
                            if t.get("special")}
        self.added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True))) \
            if self.added else None
        self.template: List[int] | None = None
        for step in _steps(spec.get("post_processor"), "processors"):
            if step.get("type") == "TemplateProcessing":
                self.template = self._template(step)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.clean_up_spaces = clean_up_spaces
        self.cache: Dict[str, List[int]] = {}
        # transformers' bos_token_id: tokenizer_config.json's bos_token
        # (from_dir), else the template's leading special token
        self.bos_token_id: int | None = (self.template[0] if self.template
                                         else None)

    @classmethod
    def from_dir(cls, d: str | Path) -> "Llama3Tokenizer":
        d = Path(d)
        path = d / "tokenizer.json"
        if not path.is_file():
            raise FileNotFoundError(
                f"no tokenizer.json in {d}: the Llama-3 tokenizer is read from "
                "<ckpt_dir>/llava/tokenizer.json (the HF fast-tokenizer file)")
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        conf = {}
        cfg = d / "tokenizer_config.json"
        if cfg.is_file():
            with open(cfg, encoding="utf-8") as f:
                conf = json.load(f)
        tok = cls(spec, bool(conf.get("clean_up_tokenization_spaces", False)))
        bos = conf.get("bos_token")
        bos = bos.get("content") if isinstance(bos, dict) else bos
        if bos is not None:
            tok.bos_token_id = tok.added.get(bos, tok.vocab.get(bos))
        return tok

    @staticmethod
    def _template(step: dict) -> List[int]:
        """The ids before `$A` in the single-sequence template (the text is
        last in Llama-3's; other layouts are refused)."""
        ids, items = [], step["single"]
        for k, item in enumerate(items):
            if "Sequence" in item:
                if k != len(items) - 1:
                    raise NotImplementedError("tokenizer.json: text before "
                                              "special tokens in the template")
            else:
                ids += step["special_tokens"][item["SpecialToken"]["id"]]["ids"]
        return ids

    # ------------------------------------------------------------ encode
    def _bpe(self, piece: str) -> List[int]:
        if piece in self.cache:
            return self.cache[piece]
        if self.ignore_merges and piece in self.vocab:
            ids = [self.vocab[piece]]
        else:
            word = list(piece)
            while len(word) > 1:
                rank, pair = min((self.ranks.get(p, len(self.ranks)), p)
                                 for p in zip(word, word[1:]))
                if rank == len(self.ranks):
                    break
                merged, i = [], 0
                while i < len(word):
                    if i + 1 < len(word) and (word[i], word[i + 1]) == pair:
                        merged.append(word[i] + word[i + 1])
                        i += 2
                    else:
                        merged.append(word[i])
                        i += 1
                word = merged
            # no unk token: a symbol outside the vocabulary is dropped
            ids = [self.vocab[w] for w in word if w in self.vocab]
        self.cache[piece] = ids
        return ids

    def _pieces(self, text: str) -> List[str]:
        if self.split is None:
            return [text] if text else []
        out, pos = [], 0
        for m in self.split.finditer(text):
            if m.start() > pos:
                out.append(text[pos:m.start()])
            if m.end() > m.start():
                out.append(m.group())
            pos = m.end()
        if pos < len(text):
            out.append(text[pos:])
        return out

    def _encode_text(self, text: str) -> List[int]:
        ids = []
        for piece in self._pieces(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids += self._bpe(mapped)
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids, pos = [], 0
        if self.added_re is not None:
            for m in self.added_re.finditer(text):
                ids += self._encode_text(text[pos:m.start()])
                ids.append(self.added[m.group()])
                pos = m.end()
        ids += self._encode_text(text[pos:])
        if add_special_tokens and self.template:
            ids = self.template + ids
        return ids

    # ------------------------------------------------------------ decode
    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Ids outside the vocabulary are dropped, as `tokenizers` does."""
        raw = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            if all(c in self.byte_decoder for c in tok):
                raw += bytes(self.byte_decoder[c] for c in tok)
            else:
                raw += tok.encode("utf-8")
        text = raw.decode("utf-8", errors="replace")
        return _clean_up_tokenization(text) if self.clean_up_spaces else text
