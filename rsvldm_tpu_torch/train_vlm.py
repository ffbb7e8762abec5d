"""LLaVA finetune CLI of the port (train_vlm.py): LoRA / QLoRA, projector
tuning, DPO, every data template and video records.

Conversation JSON records (llama_3, chatml, v1 or plain template) over a
frozen 16/8/4-bit base, gradient checkpointing (per-block recompute),
length-grouped batches padded to a multiple of --pad_to. Recipes:
- `--tune lora` (the default): LoRA on every decoder projection. Image
  records use the LLaVA-1.5 "pad" recipe (expand2square -> one tile ->
  projector) or the llava-next "anyres" token stream; video records
  (`--video_folder`: frame folders, a path holding shareVideoGPTV, or
  container files read with OpenCV) become the pooled per-frame stream
  (`--mm_spatial_pool_{stride,mode}`, `--mm_newline_position`). The
  features are spliced in at <image>, their positions unsupervised.
- `--tune projector`: the pretrain stage, the projector alone, inside the
  differentiated graph (a zero span reserved at <image>, filled in the
  step); `--tune lora,projector`: the joint finetune, the projector at
  `--mm_projector_lr`. Every record needs an image and <image>; pad only.
- `--dpo`: preference pairs {prompt, chosen, rejected}, LoRA only, the
  frozen base as the reference policy (`--dpo_beta`).

Smoke (no checkpoint: a tiny seeded decoder and a crc32 word tokenizer;
image records are read as text, as the JAX CLI does; projector tuning
and video records get seeded stand-in features):
  python -m rsvldm_tpu_torch.train_vlm --smoke --data_path train.json \\
      --output_dir out --steps 20 --device cpu

It runs on CUDA unless given --device cpu, and raises without a card. The
loop itself is `train(args, cap, ...)`, which takes a built LlavaCaptioner
(LlavaCaptioner.load / .from_state_dict / .seeded); without --smoke the
CLI reads <ckpt_dir>/llava and exits, as the JAX one does, when there is
none. It writes lora_final.npz and, when the projector trains,
projector_final.npz (either package reads both).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .device import compute_dtype, resolve_device
from .models.vlm.generate import IMAGE_TOKEN_INDEX, anyres_image_features
from .models.vlm.llama import LlamaConfig
from .models.vlm.vision import CLIP_MEAN, CLIPVisionConfig, normalize_pixels
from .training.vlm_data import (IGNORE_INDEX, ChatMLSpecial,
                                LazyConversationDataset,
                                LazyPreferenceDataset, Llama3Special,
                                get_modality_length_grouped_indices)
from .training.vlm_trainer import (DPOTrainer, LoraConfig, MMTrainer,
                                   VLMTrainer, save_lora_npz,
                                   save_projector_npz)

# the JAX CLI's smoke decoder; the tower is only there to make a captioner
SMOKE_LLAMA = LlamaConfig(vocab_size=512, dim=32, layers=2, heads=4,
                          kv_heads=2, ffn_dim=64)
SMOKE_VISION = CLIPVisionConfig(image_size=28, patch_size=14, width=24,
                                layers=2, heads=2)
SMOKE_SPECIAL = Llama3Special(bos=501, start_header=502, end_header=503,
                              eot=504, nl=505)
# the smoke projector tuning's stand-in tower features: tokens x width
SMOKE_IMG_TOKENS, SMOKE_VIS_DIM = 4, 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", default="ckpts")
    p.add_argument("--data_path", required=True,
                   help="conversation JSON/JSONL (llava train format)")
    p.add_argument("--image_folder", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--template", default="llama_3",
                   choices=["llama_3", "chatml", "v1", "plain"])
    p.add_argument("--bits", type=int, default=8, choices=[16, 8, 4],
                   help="frozen-base precision (8/4 = QLoRA)")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--tune", default="lora",
                   help="comma list of {lora, projector}: 'projector' alone "
                        "is the pretrain stage, 'lora,projector' the joint "
                        "finetune with --mm_projector_lr as the projector's "
                        "learning rate")
    p.add_argument("--mm_projector_lr", type=float, default=None)
    p.add_argument("--image_aspect_ratio", default="pad",
                   choices=["pad", "anyres"],
                   help="pad = LLaVA-1.5 square recipe; anyres = the "
                        "llava-next multi-tile recipe (LoRA tuning only)")
    p.add_argument("--video_folder", default=None,
                   help="root of records with a 'video' key: frame folders "
                        "(shareVideoGPTV paths) or container files (OpenCV)")
    p.add_argument("--video_fps", type=int, default=1)
    p.add_argument("--frames_upbound", type=int, default=0)
    p.add_argument("--force_sample", action="store_true")
    p.add_argument("--add_time_instruction", action="store_true")
    p.add_argument("--mm_spatial_pool_stride", type=int, default=2)
    p.add_argument("--mm_spatial_pool_mode", default="bilinear",
                   choices=["average", "max", "bilinear"])
    p.add_argument("--mm_newline_position", default="grid",
                   choices=["grid", "frame", "one_token", "no_token"])
    p.add_argument("--dpo", action="store_true",
                   help="preference optimization over {prompt, chosen, "
                        "rejected} records; LoRA only, the frozen base is "
                        "the reference policy")
    p.add_argument("--dpo_beta", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0,
                   help="stop after N steps (0 = full epochs)")
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--pad_to", type=int, default=64)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--num_workers", type=int, default=4,
                   help="threaded record-decode workers (0 = inline); "
                        "order-preserving, so the stream is the same for "
                        "any count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   default=True)
    p.add_argument("--no_gradient_checkpointing", action="store_false",
                   dest="gradient_checkpointing")
    p.add_argument("--smoke", action="store_true",
                   help="tiny seeded model, no checkpoint needed")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def check_args(args) -> tuple:
    """The tuned parts, after the JAX CLI's refusals of flag combinations."""
    tune = tuple(t.strip() for t in args.tune.split(",") if t.strip())
    if not tune or not set(tune) <= {"lora", "projector"}:
        sys.exit(f"--tune {args.tune}: a comma list of lora, projector")
    if args.force_sample and args.frames_upbound <= 0:
        sys.exit("--force_sample samples exactly --frames_upbound frames; "
                 "pass --frames_upbound N (> 0)")
    if args.dpo and tune != ("lora",):
        sys.exit("--dpo optimizes LoRA adapters only (the frozen base is "
                 "the reference policy) — use --tune lora")
    return tune


def to_unit_pixels(pixels) -> torch.Tensor:
    """uint8 [0, 255] image array -> float32 [0, 1] (what normalize_pixels
    takes)."""
    return torch.from_numpy(np.array(pixels, np.float32)) / 255.0


def _hash_encode(text: str):
    """Deterministic whitespace tokenizer for --smoke (crc32: stable across
    processes)."""
    return [2 + zlib.crc32(w.encode()) % 498 for w in text.split()]


class HashTokenizer:
    """`_hash_encode` behind the tokenizer interface the captioner takes."""

    def encode(self, text, add_special_tokens=False):
        return _hash_encode(text)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids)


def smoke_preprocess_kw(template: str) -> dict:
    """Special ids above the smoke tokenizer's words (2..499), per
    template."""
    return {"llama_3": {"sp": SMOKE_SPECIAL},
            "chatml": {"sp": ChatMLSpecial(im_start=506, im_end=507, nl=508)},
            "v1": {"bos": 501, "sep2_id": 504},
            "plain": {"bos": 501}}[template]


def splice_training_sample(ids, labels, embed_fn, feats, ignore_index):
    """ids may hold one IMAGE_TOKEN_INDEX: it becomes the image feature
    stream and its labels span IGNORE. Returns (embeds [S', D], labels
    [S'])."""
    ids = np.asarray(ids)
    labels = np.asarray(labels)
    emb = embed_fn(np.where(ids == IMAGE_TOKEN_INDEX, 0, ids))
    img_pos = np.where(ids == IMAGE_TOKEN_INDEX)[0]
    if img_pos.size and feats is not None:
        pos = int(img_pos[0])
        emb = torch.cat([emb[:pos], feats.to(emb.dtype), emb[pos + 1:]], dim=0)
        labels = np.concatenate([
            labels[:pos], np.full((feats.shape[0],), ignore_index,
                                  labels.dtype), labels[pos + 1:]])
    return emb, labels


def reserve_image_span(ids, labels, embed_fn, t, ignore_index):
    """The <image> id expanded into a zero-filled span of t rows (labels
    IGNORE there), which the projector fills inside the train step
    (mm_loss). Returns (embeds [S', D], labels [S'], the span's start)."""
    ids = np.asarray(ids)
    labels = np.asarray(labels)
    where = np.where(ids == IMAGE_TOKEN_INDEX)[0]
    if not where.size:
        raise SystemExit(
            "record has an 'image' field but no '<image>' token in its "
            "conversation text — projector tuning needs the placeholder")
    pos = int(where[0])
    emb = embed_fn(np.where(ids == IMAGE_TOKEN_INDEX, 0, ids))
    emb = torch.cat([emb[:pos], emb.new_zeros((t, emb.shape[1])),
                     emb[pos + 1:]], dim=0)
    labels = np.concatenate([labels[:pos], np.full((t,), ignore_index,
                                                   labels.dtype),
                             labels[pos + 1:]])
    return emb, labels, pos


@dataclasses.dataclass
class Features:
    """Where a batch's image and video rows come from.
    process_image: the dataset's path -> item["image"];
    image: item["image"] -> projected features [T, D] (LoRA recipes, DPO);
    image_raw: item["image"] -> tower features [T, Dv] before the
    projector (projector tuning), T = img_tokens;
    video: item["video"] (PIL frames) -> the stream [T', D]."""
    process_image: Optional[Callable] = None
    image: Optional[Callable] = None
    image_raw: Optional[Callable] = None
    video: Optional[Callable] = None
    img_tokens: int = 0


def captioner_features(args, cap, tune) -> Features:
    """The captioner's tower and projector behind each recipe."""
    from PIL import Image
    from .models.vlm.anyres import expand2square
    size = cap.vision.cfg.image_size
    dev, dt = cap.image_newline.device, cap.image_newline.dtype

    def video(frames):
        return cap.video_features(frames, stride=args.mm_spatial_pool_stride,
                                  pool_mode=args.mm_spatial_pool_mode,
                                  newline_position=args.mm_newline_position)

    if args.image_aspect_ratio == "anyres":
        if "projector" in tune:
            sys.exit("--image_aspect_ratio anyres supports LoRA tuning only "
                     "(variable per-image token count)")
        return Features(
            process_image=lambda path: Image.open(path).convert("RGB"),
            image=lambda im: anyres_image_features(
                cap.vision, cap.projector, im, cap.image_newline, size),
            video=video)
    bg = tuple(int(255 * m) for m in CLIP_MEAN)

    def process_image(path):
        img = expand2square(Image.open(path).convert("RGB"), bg)
        return np.asarray(img.resize((size, size), Image.BICUBIC))

    def tower(pixels):  # [size, size, 3] uint8 -> [T, Dv]
        return cap.vision(normalize_pixels(to_unit_pixels(pixels)[None]
                                           .to(dev, dt)))[0]

    def image(pixels):
        w = next(cap.projector.parameters())
        return cap.projector(tower(pixels).to(w.dtype))

    return Features(process_image=process_image, image=image,
                    image_raw=tower, video=video,
                    img_tokens=(size // cap.vision.cfg.patch_size) ** 2)


def smoke_features(cap, tune) -> Features:
    """The JAX CLI's smoke stand-ins, drawn with numpy from its seeds: tower
    features N(0, 1) [4, 8] (seed 11) for every image when the projector
    trains (then cap's projector becomes a seeded 8 -> D one), and N(0, 1)
    [4 per frame, D] (seed 13) for every video."""
    from .models.vlm.projector import MLPProjector
    from .utils.weights import seeded_init_
    dev = cap.image_newline.device
    dim = cap.llama.cfg.dim
    vis = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (SMOKE_IMG_TOKENS, SMOKE_VIS_DIM)).astype(np.float32)).to(dev)

    def video(frames):
        return torch.from_numpy(np.random.default_rng(13).standard_normal(
            (len(frames) * 4, dim)).astype(np.float32)).to(dev)

    if "projector" not in tune:
        return Features(video=video)
    cap.projector = seeded_init_(MLPProjector(SMOKE_VIS_DIM, dim).to(dev),
                                 "projector", dev)
    return Features(process_image=lambda path: path,
                    image_raw=lambda _: vis, video=video,
                    img_tokens=SMOKE_IMG_TOKENS)


def _pad_rows(rows, width):
    """[(embeds [S, D], labels [S])] -> (embeds [B, width, D], labels
    [B, width] int64), both on the embeddings' device."""
    emb = torch.stack([F.pad(e, (0, 0, 0, width - e.shape[0]))
                       for e, _ in rows])
    lab = np.full((len(rows), width), IGNORE_INDEX, np.int64)
    for j, (_, lt) in enumerate(rows):
        lab[j, :len(lt)] = lt
    return emb, torch.from_numpy(lab).to(emb.device)


def _refuse_empty(it, lab, max_length, what="supervised"):
    # a row whose every supervised token was cut trains on nothing (loss 0,
    # or a DPO margin of 0)
    if not (np.asarray(lab) != IGNORE_INDEX).any():
        raise SystemExit(f"record {it.get('id')}: truncation to "
                         f"--max_length {max_length} removed every "
                         f"{what} token; raise --max_length")


def train(args, cap, *, encode, preprocess_kw=None,
          features: Features | None = None, lora=None, on_step=None):
    """The finetune loop on a built LlavaCaptioner (its decoder trains, on
    the captioner's device). Returns (result dict, the trainer).
    `features` defaults to the captioner's tower and projector
    (captioner_features); Features() reads image records as text. `lora`
    gives the initial adapters (a test feeds JAX's), else the seeded
    init. `on_step`, when given, gets each step's record (step, loss,
    seconds of the train step, batch, padded width)."""
    from .data.prefetch import worker_map
    tune = check_args(args)
    model = cap.llama
    model.cfg = dataclasses.replace(model.cfg, remat=args.gradient_checkpointing)
    device = cap.image_newline.device
    if features is None:
        features = captioner_features(args, cap, tune)
    ds_cls = LazyPreferenceDataset if args.dpo else LazyConversationDataset
    ds = ds_cls(args.data_path, encode, template=args.template,
                image_folder=args.image_folder or "",
                process_image=features.process_image,
                preprocess_kw=preprocess_kw,
                video_folder=args.video_folder or "",
                video_fps=args.video_fps, frames_upbound=args.frames_upbound,
                force_sample=args.force_sample,
                add_time_instruction=args.add_time_instruction)
    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
    gen = torch.Generator().manual_seed(args.seed)
    if args.dpo:
        trainer = DPOTrainer(model, lcfg, lr=args.lr, beta=args.dpo_beta,
                             generator=gen, lora=lora)
    elif tune == ("lora",):
        trainer = VLMTrainer(model, lcfg, lr=args.lr, generator=gen, lora=lora)
    else:
        trainer = MMTrainer(model, cap.projector, lcfg, tune=tune, lr=args.lr,
                            mm_projector_lr=args.mm_projector_lr,
                            generator=gen, lora=lora)

    def embed_fn(ids):
        return model.embed(torch.as_tensor(ids, dtype=torch.long,
                                           device=device))

    def width_of(lengths):
        return -(-max(lengths) // args.pad_to) * args.pad_to

    def sft_step(items):
        rows = []
        for it in items:
            if "video" in it and features.video:
                feats = features.video(it["video"])
            else:
                feats = (features.image(it["image"])
                         if "image" in it and features.image else None)
            e, lab = splice_training_sample(it["input_ids"], it["labels"],
                                            embed_fn, feats, IGNORE_INDEX)
            # truncate after the splice (an image can be thousands of rows)
            lt = lab[:args.max_length]
            _refuse_empty(it, lt, args.max_length)
            rows.append((e[:args.max_length], lt))
        width = width_of([e.shape[0] for e, _ in rows])
        emb, lab = _pad_rows(rows, width)
        return width, lambda: trainer.train_step(emb, lab)

    def dpo_step(items):
        feats = [features.image(it["image"])
                 if "image" in it and features.image else None
                 for it in items]
        sides = {}
        for side in ("chosen", "rejected"):
            rows = []
            for it, f in zip(items, feats):
                e, lab = splice_training_sample(
                    it[f"{side}_input_ids"], it[f"{side}_labels"], embed_fn,
                    f, IGNORE_INDEX)
                lt = lab[:args.max_length]
                _refuse_empty(it, lt, args.max_length, f"supervised {side}")
                rows.append((e[:args.max_length], lt))
            sides[side] = rows
        width = width_of([e.shape[0] for rows in sides.values()
                          for e, _ in rows])
        packed = [t for rows in sides.values() for t in _pad_rows(rows, width)]
        return width, lambda: trainer.train_step(*packed)

    def mm_step(items):
        rows, pos, vis = [], [], []
        t = features.img_tokens
        for it in items:
            if "image" not in it:
                raise SystemExit("--tune projector requires image records "
                                 "(the pretrain data is image-caption pairs)")
            e, lab, p = reserve_image_span(it["input_ids"], it["labels"],
                                           embed_fn, t, IGNORE_INDEX)
            if p + t > args.max_length:
                raise SystemExit(
                    f"record {it.get('id')}: image span ends at {p + t} > "
                    f"--max_length {args.max_length}; raise the cap (the "
                    "span cannot be truncated mid-image)")
            lt = lab[:args.max_length]
            _refuse_empty(it, lt, args.max_length, "supervised caption")
            rows.append((e[:args.max_length], lt))
            pos.append(p)
            vis.append(features.image_raw(it["image"]))
        width = width_of([e.shape[0] for e, _ in rows])
        emb, lab = _pad_rows(rows, width)
        vis = torch.stack(vis)
        return width, lambda: trainer.train_step(vis, emb, pos, lab)

    make_step = dpo_step if args.dpo else (
        sft_step if tune == ("lora",) else mm_step)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    step, losses, step_s = 0, [], []
    for epoch in range(args.epochs):
        order = get_modality_length_grouped_indices(
            ds.modality_lengths, args.batch_size, 1, seed=args.seed + epoch)
        usable = len(order) - len(order) % args.batch_size
        items = worker_map(ds.__getitem__, order[:usable],
                           num_workers=args.num_workers)
        for _ in range(0, usable, args.batch_size):
            batch = [next(items) for _ in range(args.batch_size)]
            with torch.no_grad():
                width, run = make_step(batch)
            t0 = time.perf_counter()
            loss = run()
            step_s.append(time.perf_counter() - t0)  # float(loss) synced
            losses.append(loss)
            step += 1
            if on_step is not None:
                on_step(dict(step=step, loss=loss, seconds=step_s[-1],
                             batch=len(batch), width=width))
            if step % 10 == 0 or step == 1:
                print(f"step {step} epoch {epoch} loss {loss:.4f}", flush=True)
            if (args.save_every and step % args.save_every == 0
                    and trainer.lora is not None):
                save_lora_npz(trainer.lora, trainer.lora_cfg,
                              out / f"lora_step{step}.npz")
            if args.steps and step >= args.steps:
                break
        if args.steps and step >= args.steps:
            break
    if not losses:
        raise SystemExit(f"no training steps ran: {len(ds)} records with "
                         f"--batch_size {args.batch_size} yield zero full "
                         "batches")
    res = {"steps": step, "first_loss": float(losses[0]),
           "final_loss": float(losses[-1]), "losses": losses,
           "step_s": step_s}
    if trainer.lora is not None:
        save_lora_npz(trainer.lora, trainer.lora_cfg, out / "lora_final.npz")
        res["adapters"] = str(out / "lora_final.npz")
    if "projector" in tune:
        save_projector_npz(cap.projector, out / "projector_final.npz")
        res["projector"] = str(out / "projector_final.npz")
    return res, trainer


def main(argv=None):
    from .parallel.distributed import init_distributed
    args = parse_args(argv)
    tune = check_args(args)
    init_distributed()  # joins the RSVLDM_* rendezvous when it is set
    from .models.vlm.captioner import LlavaCaptioner
    device = resolve_device(args.device)
    dtype = compute_dtype(device)
    quant = {16: None, 8: "int8", 4: "int4"}[args.bits]
    if args.smoke:
        cap = LlavaCaptioner.seeded(SMOKE_LLAMA, SMOKE_VISION, HashTokenizer(),
                                    quant=quant, device=device, dtype=dtype)
        encode = _hash_encode
        pre_kw = smoke_preprocess_kw(args.template)
        features = smoke_features(cap, tune)
    else:
        cap = LlavaCaptioner.load(args.ckpt_dir, quant=quant, device=device,
                                  dtype=dtype)
        if cap is None:
            sys.exit(f"no checkpoint under {args.ckpt_dir}/llava — pass "
                     "--smoke for a random tiny model")
        encode = lambda s: cap.tokenizer.encode(s, add_special_tokens=False)
        pre_kw = {}
        if args.template == "plain":
            # the reference's plain template leads with the tokenizer's BOS
            pre_kw["bos"] = getattr(cap.tokenizer, "bos_token_id", None)
        features = captioner_features(args, cap, tune)
    res, _ = train(args, cap, encode=encode, preprocess_kw=pre_kw,
                   features=features)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
