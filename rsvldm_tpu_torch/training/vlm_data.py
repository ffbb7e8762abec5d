"""LLaVA supervised-finetuning data for the `llama_3` template
(rsvldm_tpu/training/vlm_data.py, the port's own copy).

The llama-3 conversation preprocessor masks everything but the assistant
turns (and the structural tokens) with IGNORE_INDEX; `<image>` placeholders
move to the front of their message and become IMAGE_TOKEN_INDEX;
LazyConversationDataset reads json, jsonl, brace lists and yaml manifests
and decodes image records per item; the length-grouped samplers are numpy
with a seeded Generator, so the same seed gives JAX's batch order.

Tokenizers are duck-typed: an `encode` callable (no special tokens added)
plus a Llama3Special table.

Not ported yet (ROADMAP item 15): the chatml, v1 and plain templates (they
raise), video records (they raise), the preference dataset and the
collator (`collate`, `iter_batches`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..models.vlm.generate import tokenize_with_image

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

LLAMA3_SYSTEM = ("You are a helpful language and vision assistant. "
                 "You are able to understand the visual content that the "
                 "user provides, and assist the user with a variety of "
                 "tasks using natural language.")

_ROLES = {"human": "user", "gpt": "assistant", "user": "user",
          "assistant": "assistant", "system": "system"}
_QUEUED = "not ported yet (ROADMAP item 15: training)"


def _norm_msg(msg: Dict) -> tuple[str, str]:
    """Accept both {'from', 'value'} and {'role', 'content'}."""
    role = msg.get("role", msg.get("from"))
    content = msg.get("content", msg.get("value"))
    return _ROLES.get(role, role), content


@dataclasses.dataclass(frozen=True)
class Llama3Special:
    bos: int = 128000            # <|begin_of_text|>
    start_header: int = 128006   # <|start_header_id|>
    end_header: int = 128007     # <|end_header_id|>
    eot: int = 128009            # <|eot_id|>
    nl: int = 271                # "\n\n" single token

    @property
    def unmask(self) -> tuple:
        # structural tokens stay supervised everywhere
        return (self.bos, self.start_header, self.end_header, self.eot,
                self.nl)


def preprocess_llama3(source: Sequence[Dict], encode,
                      sp: Llama3Special = Llama3Special(),
                      system_message: str = LLAMA3_SYSTEM
                      ) -> tuple[np.ndarray, np.ndarray]:
    """One conversation -> (input_ids, labels) int32, assistant spans and
    structural tokens supervised:
    <|begin_of_text|> then per message
    <|start_header_id|>{role}<|end_header_id|>\\n\\n{content}<|eot_id|>."""
    msgs = list(source)
    if msgs and _norm_msg(msgs[0])[0] != "user":
        msgs = msgs[1:]
    ids: List[int] = [sp.bos]
    labels: List[int] = [IGNORE_INDEX]

    def seg(role: str, content: str) -> List[int]:
        return ([sp.start_header] + encode(role) + [sp.end_header]
                + tokenize_with_image("\n\n" + content, encode,
                                      IMAGE_TOKEN_INDEX).tolist()
                + [sp.eot])

    sys_seg = seg("system", system_message)
    ids += sys_seg
    labels += [IGNORE_INDEX] * len(sys_seg)
    for msg in msgs:
        role, content = _norm_msg(msg)
        s = seg(role, content)
        ids += s
        labels += (s if role == "assistant" else [IGNORE_INDEX] * len(s))
    ids_np = np.asarray(ids, np.int32)
    labels_np = np.asarray(labels, np.int32)
    for t in sp.unmask:
        labels_np[ids_np == t] = t
    labels_np[ids_np == IMAGE_TOKEN_INDEX] = IGNORE_INDEX
    return ids_np, labels_np


def normalize_multimodal(source: Sequence[Dict]) -> List[Dict]:
    """Every message holding <image> gets its placeholder(s) moved to the
    front as '<image>\\n', the layout inference uses."""
    out = []
    for msg in source:
        role_key = "value" if "value" in msg else "content"
        content = msg.get(role_key, "")
        if DEFAULT_IMAGE_TOKEN in content:
            n = content.count(DEFAULT_IMAGE_TOKEN)
            content = content.replace(DEFAULT_IMAGE_TOKEN, "").strip()
            content = ((DEFAULT_IMAGE_TOKEN + "\n") * n + content).strip()
            msg = {**msg, role_key: content}
        out.append(msg)
    return out


PREPROCESSORS = {"llama_3": preprocess_llama3, "llama_v3": preprocess_llama3}


def preprocess(source: Sequence[Dict], encode, template: str, **kw
               ) -> tuple[np.ndarray, np.ndarray]:
    """Template dispatch; only the llama-3 template is ported."""
    if template not in PREPROCESSORS:
        raise NotImplementedError(f"conversation template {template!r} is "
                                  f"{_QUEUED}; use llama_3")
    return PREPROCESSORS[template](source, encode, **kw)


class LazyConversationDataset:
    """Records load eagerly (they are small); tokenization and image
    decoding happen per item.

    data_path: .json (a list of records), .jsonl, a brace list
    'base{a,b}.json', or a .yaml manifest whose datasets carry a
    sampling_strategy of first/end/random:N or N%."""

    def __init__(self, data_path: str, encode, template: str = "llama_3",
                 image_folder: str = "",
                 process_image: Optional[Callable] = None, seed: int = 0,
                 preprocess_kw: Optional[Dict] = None):
        if template not in PREPROCESSORS:
            raise NotImplementedError(f"conversation template {template!r} "
                                      f"is {_QUEUED}; use llama_3")
        self.encode = encode
        self.template = template
        self.image_folder = Path(image_folder) if image_folder else None
        self.process_image = process_image
        self.preprocess_kw = preprocess_kw or {}
        self.records: List[Dict] = self._load(str(data_path), seed)

    @staticmethod
    def _read_one(path: str) -> List[Dict]:
        with open(path) as f:
            if path.endswith(".jsonl"):
                return [json.loads(ln) for ln in f if ln.strip()]
            return json.load(f)

    def _load(self, data_path: str, seed: int) -> List[Dict]:
        out: List[Dict] = []
        m = re.match(r"^(.*)\{(.*)\}\.json$", data_path)
        if m:
            base, names = m.groups()
            for n in names.split(","):
                out.extend(self._read_one(f"{base}{n}.json"))
            return out
        if data_path.endswith(".yaml"):
            import yaml
            with open(data_path) as f:
                manifest = yaml.safe_load(f)
            rng = np.random.default_rng(seed)
            for ds in manifest["datasets"]:
                cur = self._read_one(ds["json_path"])
                strat = ds.get("sampling_strategy", "all")
                if ":" in strat:
                    strat, num = strat.split(":")
                    n = (math.ceil(int(num.rstrip("%")) * len(cur) / 100)
                         if "%" in num else int(num))
                    if strat == "first":
                        cur = cur[:n]
                    elif strat == "end":
                        cur = cur[-n:]
                    elif strat == "random":
                        cur = [cur[i] for i in rng.permutation(len(cur))[:n]]
                out.extend(cur)
            return out
        return self._read_one(data_path)

    def __len__(self) -> int:
        return len(self.records)

    @staticmethod
    def _words(rec: Dict) -> int:
        return sum(len(c.get("value", c.get("content", "")).split())
                   for c in rec["conversations"])

    @property
    def lengths(self) -> List[int]:
        """Word counts, +128 when an image is present."""
        return [(128 if "image" in rec else 0) + self._words(rec)
                for rec in self.records]

    @property
    def modality_lengths(self) -> List[int]:
        """Word counts, positive for multimodal records and negative for
        text-only ones."""
        return [self._words(rec) if ("image" in rec or "video" in rec)
                else -self._words(rec) for rec in self.records]

    def _load_images(self, rec: Dict):
        """'image' is a path or a list of paths; returns the processed
        image(s) in kind."""
        path = rec["image"]
        paths = path if isinstance(path, list) else [path]
        imgs = [self.process_image(
            str(self.image_folder / p) if self.image_folder else p)
            for p in paths]
        return imgs if isinstance(path, list) else imgs[0]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        if "video" in rec and "image" not in rec:
            raise NotImplementedError(f"record {rec.get('id', i)}: video "
                                      f"records are {_QUEUED}")
        conv = rec["conversations"]
        if "image" in rec:
            conv = normalize_multimodal(conv)
        ids, labels = preprocess(conv, self.encode, self.template,
                                 **self.preprocess_kw)
        item: Dict[str, Any] = {"input_ids": ids, "labels": labels,
                                "id": rec.get("id", i)}
        if "image" in rec and self.process_image is not None:
            item["image"] = self._load_images(rec)
        return item


# ---------------------------------------------------- length-grouped order
def split_to_even_chunks(indices: List[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy shortest-chunk assignment into equal-count chunks."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    totals = [0.0] * num_chunks
    for idx in indices:
        short = totals.index(min(totals))
        chunks[short].append(idx)
        totals[short] += lengths[idx]
        if len(chunks[short]) == per:
            totals[short] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int, seed: int = 0) -> List[int]:
    """Random permutation -> megabatches -> sorted by length, longest
    first, inside each -> even chunks per rank."""
    rng = np.random.default_rng(seed)
    indices = rng.permutation(len(lengths)).tolist()
    mb = batch_size * world_size
    megabatches = [sorted(indices[i:i + mb], key=lambda j: lengths[j],
                          reverse=True)
                   for i in range(0, len(indices), mb)]
    return [i for m in megabatches
            for chunk in split_to_even_chunks(m, lengths, world_size)
            for i in chunk]


def get_modality_length_grouped_indices(lengths: Sequence[int],
                                        batch_size: int, world_size: int,
                                        seed: int = 0) -> List[int]:
    """Multimodal (length > 0) and text-only (length < 0) records grouped
    apart, megabatches shuffled together, the two trailing partial ones
    merged last."""
    assert all(n != 0 for n in lengths), "zero-length sample"
    if all(n > 0 for n in lengths) or all(n < 0 for n in lengths):
        # signed lengths pass through: an all-text corpus sorts shortest
        # absolute length first, as the reference does
        return get_length_grouped_indices(lengths, batch_size, world_size,
                                          seed)
    mm = [(i, n) for i, n in enumerate(lengths) if n > 0]
    lang = [(i, -n) for i, n in enumerate(lengths) if n < 0]
    mm_order = get_length_grouped_indices([n for _, n in mm], batch_size,
                                          world_size, seed)
    lang_order = get_length_grouped_indices([n for _, n in lang], batch_size,
                                            world_size, seed)
    mm_shuffle = [mm[j][0] for j in mm_order]
    lang_shuffle = [lang[j][0] for j in lang_order]
    mb = batch_size * world_size
    mm_mega = [mm_shuffle[i:i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_mega = [lang_shuffle[i:i + mb]
                 for i in range(0, len(lang_shuffle), mb)]
    additional = (mm_mega[-1] if mm_mega else []) + \
        (lang_mega[-1] if lang_mega else [])
    megabatches = mm_mega[:-1] + lang_mega[:-1]
    rng = np.random.default_rng(seed + 1)
    megabatches = [megabatches[i] for i in rng.permutation(len(megabatches))]
    if additional:
        megabatches.append(sorted(additional))
    return [i for m in megabatches for i in m]
