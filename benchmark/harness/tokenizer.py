"""The stand-in tokenizer both sides are given (no tokenizer assets are in
the repository): the chat template's special strings to the
configuration's special ids, every other whitespace-separated word to a
crc32 bucket in the configuration's word range, so a prompt has about its
BPE length. `decode` writes ids as words and records the ids it was given
(`decoded`): the captioner decodes its served tokens through it."""

from __future__ import annotations

import re
import zlib


class StandInTokenizer:
    def __init__(self, special: dict, words: tuple):
        self.special = {k: int(v) for k, v in special.items()}
        self.lo, self.hi = int(words[0]), int(words[1])
        self._split = re.compile("(" + "|".join(map(re.escape, self.special))
                                 + ")")
        self._special_ids = set(self.special.values())
        self.decoded: list = []

    @classmethod
    def of(cls, spec: dict) -> "StandInTokenizer":
        t = spec["tokenizer"]
        return cls(t["special"], tuple(t["words"]))

    def encode(self, text, add_special_tokens=False):
        ids = []
        for part in self._split.split(text):
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids += [self.lo + zlib.crc32(w.encode()) % (self.hi - self.lo)
                        for w in part.split()]
        return ids

    def decode(self, ids, skip_special_tokens=True):
        self.decoded.append([int(i) for i in ids])
        return " ".join(f"w{i}" for i in ids if i not in self._special_ids)
