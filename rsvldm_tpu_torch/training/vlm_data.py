"""LLaVA finetuning data (rsvldm_tpu/training/vlm_data.py, the port's own
copy).

The conversation preprocessors (llama_3, chatml, v1, plain) mask everything
but the assistant turns (and each template's structural tokens) with
IGNORE_INDEX; `<image>` placeholders move to the front of their message and
become IMAGE_TOKEN_INDEX. LazyConversationDataset reads json, jsonl, brace
lists and yaml manifests and decodes image and video records per item;
LazyPreferenceDataset makes DPO's chosen / rejected pairs through the same
templates; `collate` pads a batch and `iter_batches` walks an epoch. The
length-grouped samplers are numpy with a seeded Generator, so the same seed
gives JAX's batch order.

Tokenizers are duck-typed: an `encode` callable (no special tokens added)
plus a special-token table.
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
QWEN_SYSTEM = "You are a helpful assistant."

_ROLES = {"human": "user", "gpt": "assistant", "user": "user",
          "assistant": "assistant", "system": "system"}


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
                + _encode_with_image("\n\n" + content, encode) + [sp.eot])

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


def _encode_with_image(text: str, encode) -> List[int]:
    return tokenize_with_image(text, encode, IMAGE_TOKEN_INDEX).tolist()


@dataclasses.dataclass(frozen=True)
class ChatMLSpecial:
    im_start: int = 151644
    im_end: int = 151645
    nl: int = 198                # "\n"

    @property
    def unmask(self) -> tuple:
        return (self.nl, self.im_start, self.im_end)


def preprocess_chatml(source: Sequence[Dict], encode,
                      sp: ChatMLSpecial = ChatMLSpecial(),
                      system_message: str = QWEN_SYSTEM
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The Qwen / chatml template: <|im_start|>{role}\\n{content}
    <|im_end|>\\n per message, assistant turns and structural tokens
    supervised."""
    msgs = list(source)
    if msgs and _norm_msg(msgs[0])[0] != "user":
        msgs = msgs[1:]

    def seg(role: str, content: str) -> List[int]:
        return ([sp.im_start] + encode(role)
                + _encode_with_image("\n" + content, encode)
                + [sp.im_end, sp.nl])

    sys_seg = seg("system", system_message)
    ids: List[int] = list(sys_seg)
    labels: List[int] = [IGNORE_INDEX] * len(sys_seg)
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


def preprocess_v1(source: Sequence[Dict], encode, bos: int = 1,
                  sep2_id: int = 2, system: str = "",
                  boundary_compat: bool = False,
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Vicuna v1: '{system} USER: {q} ASSISTANT: {a}</s>...'; the answers
    and their closing </s> supervise. Each round is encoded as one string
    and its prompt prefix masked (the ids equal inference's tokenization);
    boundary_compat=True encodes prompt and answer apart instead, closer
    to the reference's label mask. A trailing unpaired human turn stays in
    the ids, masked."""
    msgs = list(source)
    if msgs and _norm_msg(msgs[0])[0] != "user":
        msgs = msgs[1:]
    ids: List[int] = [bos]
    labels: List[int] = [IGNORE_INDEX]
    head = encode(system + " ") if system else []
    ids += head
    labels += [IGNORE_INDEX] * len(head)
    for i in range(0, len(msgs) - 1, 2):
        _, q = _norm_msg(msgs[i])
        _, a = _norm_msg(msgs[i + 1])
        prompt_text = f"USER: {q} ASSISTANT: "
        if boundary_compat:
            prompt = _encode_with_image(prompt_text, encode)
            answer = _encode_with_image(a, encode) + [sep2_id]
            ids += prompt + answer
            labels += [IGNORE_INDEX] * len(prompt) + answer
        else:
            round_ids = _encode_with_image(prompt_text + a, encode)
            # a merge across the prompt | answer seam can make the joint
            # encoding shorter than the prompt's alone
            prompt_len = min(len(_encode_with_image(prompt_text, encode)),
                             len(round_ids))
            ids += round_ids + [sep2_id]
            labels += ([IGNORE_INDEX] * prompt_len + round_ids[prompt_len:]
                       + [sep2_id])
    if len(msgs) % 2 == 1:
        _, q = _norm_msg(msgs[-1])
        tail = _encode_with_image(f"USER: {q} ", encode)
        ids += tail
        labels += [IGNORE_INDEX] * len(tail)
    ids_np = np.asarray(ids, np.int32)
    labels_np = np.asarray(labels, np.int32)
    labels_np[ids_np == IMAGE_TOKEN_INDEX] = IGNORE_INDEX
    return ids_np, labels_np


def preprocess_plain(source: Sequence[Dict], encode, sep: str = "\n",
                     bos: Optional[int] = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The pretraining alignment format: [bos] + <image> + answer + sep,
    the answer supervised. `bos` is the tokenizer's BOS (None: none)."""
    if len(source) != 2:
        raise ValueError(f"plain template: {len(source)} messages, not 2")
    _, first = _norm_msg(source[0])
    if DEFAULT_IMAGE_TOKEN not in first:
        raise ValueError("plain template: the first message has no <image>")
    _, answer = _norm_msg(source[1])
    prompt_ids = (([] if bos is None else [bos])
                  + _encode_with_image(DEFAULT_IMAGE_TOKEN, encode))
    ids = prompt_ids + encode(answer + sep)
    labels = [IGNORE_INDEX] * len(prompt_ids) + ids[len(prompt_ids):]
    return np.asarray(ids, np.int32), np.asarray(labels, np.int32)


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


PREPROCESSORS = {
    "llama_3": preprocess_llama3,
    "llama_v3": preprocess_llama3,
    "qwen": preprocess_chatml,
    "chatml": preprocess_chatml,
    "v1": preprocess_v1,
    "plain": preprocess_plain,
}


def preprocess(source: Sequence[Dict], encode, template: str, **kw
               ) -> tuple[np.ndarray, np.ndarray]:
    """Template dispatch."""
    if template not in PREPROCESSORS:
        raise ValueError(f"unknown conversation template: {template}")
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
                 preprocess_kw: Optional[Dict] = None,
                 video_folder: str = "", video_fps: int = 1,
                 frames_upbound: int = 0, force_sample: bool = False,
                 add_time_instruction: bool = False,
                 process_frame: Optional[Callable] = None):
        """Records with a "video" key load a frame folder (a path holding
        "shareVideoGPTV") or a container file (models/vlm/video.py::
        process_video, on cv2); process_frame(pil) -> array preprocesses
        each sampled frame (default: the PIL frames)."""
        self.encode = encode
        self.template = template
        self.image_folder = Path(image_folder) if image_folder else None
        self.process_image = process_image
        self.video_folder = Path(video_folder) if video_folder else None
        self.video_fps = video_fps
        self.frames_upbound = frames_upbound
        self.force_sample = force_sample
        self.add_time_instruction = add_time_instruction
        self.process_frame = process_frame
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

    def _load_video(self, rec: Dict, conv):
        """A frame folder ("shareVideoGPTV" in the path) gives 10 uniform
        frames at an assumed 2 fps (frames_upbound with force_sample); a
        container file goes through process_video. With
        add_time_instruction the first turn becomes '<image>\\n{the
        instruction}\\n{the turn without <image>}'."""
        from PIL import Image

        from ..models.vlm.video import (process_video, sample_video_frames,
                                        time_instruction)
        path = rec["video"]
        vf = str(self.video_folder / path) if self.video_folder else path
        if "shareVideoGPTV" in vf:
            n = self.frames_upbound if self.force_sample else 10
            if n <= 0:
                raise ValueError("force_sample samples exactly "
                                 "frames_upbound frames: it must be > 0")
            frames, video_time, frame_time = sample_video_frames(vf, n)
            num = len(frames)
        else:
            arr, video_time, frame_time, num = process_video(
                vf, self.video_fps, self.frames_upbound, self.force_sample)
            frames = [Image.fromarray(a) for a in arr]
        if self.add_time_instruction:
            instr = time_instruction(video_time, num, frame_time)
            conv = [dict(m) for m in conv]
            key = "value" if "value" in conv[0] else "content"
            first = conv[0].get(key, "")
            conv[0][key] = (f"{DEFAULT_IMAGE_TOKEN}\n{instr}\n"
                            f"{first.replace(DEFAULT_IMAGE_TOKEN, '')}")
        return conv, frames

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        conv = rec["conversations"]
        frames = None
        # 'image' wins over 'video': the video is not decoded then
        if "video" in rec and "image" not in rec:
            conv, frames = self._load_video(rec, conv)
        if "image" in rec or "video" in rec:
            conv = normalize_multimodal(conv)
        ids, labels = preprocess(conv, self.encode, self.template,
                                 **self.preprocess_kw)
        item: Dict[str, Any] = {"input_ids": ids, "labels": labels,
                                "id": rec.get("id", i)}
        if "image" in rec and self.process_image is not None:
            item["image"] = self._load_images(rec)
        elif frames is not None:
            item["video"] = ([self.process_frame(f) for f in frames]
                             if self.process_frame else frames)
        return item


class LazyPreferenceDataset(LazyConversationDataset):
    """DPO preference pairs: records {"prompt", "chosen", "rejected",
    optional "image"} become two single-turn conversations through the
    same template, so the masking (prompt ignored, answer supervised) is
    SFT's."""

    @staticmethod
    def _make_conv(prompt: str, answer: str) -> List[Dict]:
        return [{"from": "human", "value": prompt},
                {"from": "gpt", "value": answer}]

    @staticmethod
    def _words(rec: Dict) -> int:
        return sum(len(rec.get(k, "").split())
                   for k in ("prompt", "chosen", "rejected"))

    @property
    def modality_lengths(self) -> List[int]:
        return [self._words(rec) if "image" in rec else -self._words(rec)
                for rec in self.records]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        item: Dict[str, Any] = {"id": rec.get("id", i)}
        for side in ("chosen", "rejected"):
            ids, labels = preprocess(
                self._make_conv(rec["prompt"], rec[side]), self.encode,
                self.template, **self.preprocess_kw)
            item[f"{side}_input_ids"] = ids
            item[f"{side}_labels"] = labels
        if "image" in rec and self.process_image is not None:
            item["image"] = self._load_images(rec)
        return item


# ---------------------------------------------------------------- collator
def collate(instances: Sequence[Dict], pad_id: int = 0,
            max_length: Optional[int] = None, pad_to_multiple: int = 64,
            padding_side: str = "right") -> Dict[str, Any]:
    """Truncate to max_length, pad input_ids with pad_id and labels with
    IGNORE_INDEX to the longest row rounded up to pad_to_multiple (never
    past max_length); attention_mask marks the tokens. Mixed batches keep
    None for a row without an image or video."""
    ids = [np.asarray(x["input_ids"])[:max_length] for x in instances]
    labels = [np.asarray(x["labels"])[:max_length] for x in instances]
    width = max(len(x) for x in ids)
    if pad_to_multiple:
        width = -(-width // pad_to_multiple) * pad_to_multiple
    if max_length:
        width = min(width, max_length)
    b = len(ids)
    out_ids = np.full((b, width), pad_id, np.int32)
    out_labels = np.full((b, width), IGNORE_INDEX, np.int32)
    mask = np.zeros((b, width), bool)
    for j, (x, y) in enumerate(zip(ids, labels)):
        if padding_side == "left":
            out_ids[j, width - len(x):] = x
            out_labels[j, width - len(y):] = y
            mask[j, width - len(x):] = True
        else:
            out_ids[j, :len(x)] = x
            out_labels[j, :len(y)] = y
            mask[j, :len(x)] = True
    batch: Dict[str, Any] = {"input_ids": out_ids, "labels": out_labels,
                             "attention_mask": mask}
    if any("image" in x for x in instances):
        batch["images"] = [x.get("image") for x in instances]
    if any("video" in x for x in instances):
        batch["videos"] = [x.get("video") for x in instances]
    return batch


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


def iter_batches(dataset: LazyConversationDataset, batch_size: int,
                 world_size: int = 1, seed: int = 0, pad_id: int = 0,
                 max_length: Optional[int] = None, pad_to_multiple: int = 64,
                 group_by_modality_length: bool = True):
    """One epoch: the length-grouped order, then collated numpy batches
    (a trailing partial batch is dropped)."""
    if group_by_modality_length:
        order = get_modality_length_grouped_indices(
            dataset.modality_lengths, batch_size, world_size, seed)
    else:
        order = get_length_grouped_indices(dataset.lengths, batch_size,
                                           world_size, seed)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        yield collate([dataset[j] for j in order[i:i + batch_size]],
                      pad_id=pad_id, max_length=max_length,
                      pad_to_multiple=pad_to_multiple)
