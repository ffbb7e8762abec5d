"""The decoder's tokenizer from <ckpt_dir>/llava/tokenizer.json, without the
`tokenizers` or `transformers` packages (the JAX captioner reads it through
transformers.AutoTokenizer, rsvldm_tpu/models/vlm/captioner.py:222-224).

It reads the shapes the Llama-family checkpoints ship: byte-level BPE
(Llama-3; Qwen2, with NFC and its own Split pattern) and SentencePiece-style
BPE with byte fallback (Mistral, Mixtral, Gemma: a Prepend / Replace
normalizer to "▁", no pre-tokenizer or a Split on a string, the Replace /
ByteFallback / Fuse / Strip decoders). A component it does not implement
raises NotImplementedError naming it: a file is never tokenized wrongly.

What it reads, in encode order:
  1. `added_tokens`, split out of the raw text first (longest match at the
     leftmost position), so that the chat template's `<|begin_of_text|>`,
     `<|start_header_id|>`, `<|eot_id|>` ... map to their ids even with
     add_special_tokens=False;
  2. the `normalizer` on each segment between them: NFC, Prepend,
     Replace of a string;
  3. the `Split` pre-tokenizer (behaviour "Isolated": matches and the text
     between them are both pieces; "MergedWithPrevious": a match ends its
     piece) in the stdlib `re`. `re` has no
     \\p{L} / \\p{N}; they become explicit classes built from
     unicodedata (letters: categories L*, numbers: N*, which takes in the
     Nl / No characters such as `½`, `²` and `Ⅻ` that `\\d` misses), and
     \\s / \\S become the Unicode White_Space set (stdlib `\\s` also takes
     U+001C-U+001F);
  4. the `ByteLevel` map of each piece's UTF-8 bytes to printable chars
     (byte-level files only);
  5. the `BPE` model: with `ignore_merges`, a piece that is in the
     vocabulary whole is one id; otherwise merges by rank, lowest first; a
     symbol left outside the vocabulary becomes its `<0xXX>` byte tokens
     with `byte_fallback`, else the unk token (runs fused with
     `fuse_unk`), else nothing.
`add_special_tokens=True` applies the `post_processor`'s TemplateProcessing
(BOS before the text). `decode` drops special added tokens when asked,
then runs the `decoder`: ByteLevel reverses the byte map (invalid UTF-8
becomes U+FFFD); Replace, ByteFallback (byte tokens to UTF-8, one U+FFFD
a byte of an invalid run), Fuse and Strip as `tokenizers` does; then
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
    for a tokenizer.json of the shapes in the module docstring."""

    def __init__(self, spec: dict, clean_up_spaces: bool = False):
        model = spec["model"]
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer.json: model {model.get('type')}")
        for knob in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(knob):
                raise NotImplementedError(f"tokenizer.json: BPE {knob}")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.unk_id = self.vocab.get(model.get("unk_token") or "")
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.normalizers = [self._normalizer(step) for step in
                            _steps(spec.get("normalizer"), "normalizers")]
        self.split = None
        self.merge_with_previous = False
        self.byte_level = False
        for step in _steps(spec.get("pre_tokenizer"), "pretokenizers"):
            kind = step.get("type")
            if kind == "Split":
                if step.get("invert") or step.get("behavior") not in (
                        "Isolated", "MergedWithPrevious"):
                    raise NotImplementedError(f"tokenizer.json: Split {step}")
                pat = step["pattern"]
                self.split = re.compile(translate_pattern(pat["Regex"]) if "Regex"
                                        in pat else re.escape(pat["String"]))
                self.merge_with_previous = step["behavior"] == "MergedWithPrevious"
            elif kind == "ByteLevel" and not step.get("use_regex") and \
                    not step.get("add_prefix_space"):
                self.byte_level = True
            else:
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
            elif step.get("type") != "ByteLevel":  # ByteLevel: offsets only
                raise NotImplementedError(
                    f"tokenizer.json: post-processor {step.get('type')}")
        self.decoders = [self._decoder(step) for step in
                         _steps(spec.get("decoder"), "decoders")]
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

    @staticmethod
    def _normalizer(step: dict) -> tuple:
        kind = step.get("type")
        if kind == "NFC":
            return ("nfc",)
        if kind == "Prepend":
            return ("prepend", step["prepend"])
        if kind == "Replace" and "String" in step["pattern"]:
            return ("replace", step["pattern"]["String"], step["content"])
        raise NotImplementedError(f"tokenizer.json: normalizer {step}")

    @staticmethod
    def _decoder(step: dict) -> tuple:
        kind = step.get("type")
        if kind in ("ByteLevel", "ByteFallback", "Fuse"):
            return (kind,)
        if kind == "Replace" and "String" in step["pattern"]:
            return (kind, step["pattern"]["String"], step["content"])
        if kind == "Strip":
            return (kind, step["content"], step["start"], step["stop"])
        raise NotImplementedError(f"tokenizer.json: decoder {step}")

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
            ids = []
            for w in word:
                if w in self.vocab:
                    ids.append(self.vocab[w])
                elif self.byte_fallback:
                    ids += [self.vocab[f"<0x{b:02X}>"] for b in w.encode("utf-8")]
                elif self.unk_id is not None:
                    if not (self.fuse_unk and ids and ids[-1] == self.unk_id):
                        ids.append(self.unk_id)
                # no unk token: a symbol outside the vocabulary is dropped
        self.cache[piece] = ids
        return ids

    def _pieces(self, text: str) -> List[str]:
        if self.split is None:
            return [text] if text else []
        out, pos = [], 0
        for m in self.split.finditer(text):
            if m.end() == m.start():
                continue
            if self.merge_with_previous:  # the match closes its piece
                out.append(text[pos:m.end()])
            else:
                if m.start() > pos:
                    out.append(text[pos:m.start()])
                out.append(m.group())
            pos = m.end()
        if pos < len(text):
            out.append(text[pos:])
        return out

    def _normalize(self, text: str) -> str:
        for step in self.normalizers:
            if step[0] == "nfc":
                text = unicodedata.normalize("NFC", text)
            elif step[0] == "prepend":
                text = step[1] + text if text else text
            else:
                text = text.replace(step[1], step[2])
        return text

    def _encode_text(self, text: str) -> List[int]:
        ids = []
        for piece in self._pieces(self._normalize(text)):
            if self.byte_level:
                piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids += self._bpe(piece)
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
        tokens = []
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            tokens.append(tok)
        for step in self.decoders:
            tokens = getattr(self, f"_dec_{step[0].lower()}")(tokens, *step[1:])
        text = "".join(tokens)
        return _clean_up_tokenization(text) if self.clean_up_spaces else text

    def _dec_bytelevel(self, tokens):
        raw = bytearray()
        for tok in tokens:
            if all(c in self.byte_decoder for c in tok):
                raw += bytes(self.byte_decoder[c] for c in tok)
            else:
                raw += tok.encode("utf-8")
        return [raw.decode("utf-8", errors="replace")]

    @staticmethod
    def _dec_replace(tokens, old, new):
        return [t.replace(old, new) for t in tokens]

    @staticmethod
    def _dec_bytefallback(tokens):
        out, run = [], bytearray()

        def flush():
            if run:
                try:
                    out.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append("\ufffd" * len(run))
                run.clear()
        for t in tokens:
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    run.append(int(t[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(t)
        flush()
        return out

    @staticmethod
    def _dec_fuse(tokens):
        return ["".join(tokens)]

    @staticmethod
    def _dec_strip(tokens, content, start, stop):
        out = []
        for t in tokens:
            i, j = 0, len(t)
            while i < min(start, len(t)) and t[i] == content:
                i += 1
            while len(t) - j < stop and j > i and t[j - 1] == content:
                j -= 1
            out.append(t[i:j])
        return out
