"""LLaVA LoRA / QLoRA finetune CLI of the port (train_vlm.py, `--tune lora`).

Conversation JSON records (llama-3 template), LoRA on every decoder
projection over a frozen 16/8/4-bit base, gradient checkpointing (per-block
recompute), length-grouped batches padded to a multiple of --pad_to. Image
records use the LLaVA-1.5 "pad" recipe (expand2square -> one tile ->
projector) or the llava-next "anyres" token stream; the features are
spliced in at the <image> token and their positions are unsupervised.

Smoke (no checkpoint: a tiny seeded decoder and a crc32 word tokenizer;
image records are read as text, as the JAX CLI does):
  python -m rsvldm_tpu_torch.train_vlm --smoke --data_path train.json \\
      --output_dir out --steps 20 --device cpu

It runs on CUDA unless given --device cpu, and raises without a card. The
loop itself is `train(args, captioner, ...)`, which takes a built
LlavaCaptioner (LlavaCaptioner.load / .from_state_dict / .seeded); without
--smoke the CLI reads <ckpt_dir>/llava (LlavaCaptioner.load: the shards,
the Llava-next PEFT merge, tokenizer.json) and exits, as the JAX one does,
when there is none. Not ported yet (they raise, ROADMAP item 15):
--dpo, --tune projector, --video_folder and templates other than llama_3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .device import compute_dtype, resolve_device
from .models.vlm.generate import IMAGE_TOKEN_INDEX, anyres_image_features
from .models.vlm.llama import LlamaConfig
from .models.vlm.vision import CLIP_MEAN, CLIPVisionConfig, normalize_pixels
from .training.vlm_data import (IGNORE_INDEX, LazyConversationDataset,
                                Llama3Special,
                                get_modality_length_grouped_indices)
from .training.vlm_trainer import LoraConfig, VLMTrainer, save_lora_npz

_QUEUED = "is not ported yet (ROADMAP item 15: training)"
# the JAX CLI's smoke decoder; the tower is only there to make a captioner
SMOKE_LLAMA = LlamaConfig(vocab_size=512, dim=32, layers=2, heads=4,
                          kv_heads=2, ffn_dim=64)
SMOKE_VISION = CLIPVisionConfig(image_size=28, patch_size=14, width=24,
                                layers=2, heads=2)
SMOKE_SPECIAL = Llama3Special(bos=501, start_header=502, end_header=503,
                              eot=504, nl=505)


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
                   help="lora (projector tuning is not ported yet)")
    p.add_argument("--image_aspect_ratio", default="pad",
                   choices=["pad", "anyres"])
    p.add_argument("--video_folder", default=None)
    p.add_argument("--dpo", action="store_true")
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


def refuse_unported(args) -> None:
    if args.dpo:
        raise NotImplementedError(f"--dpo {_QUEUED}")
    if args.tune.replace(" ", "") != "lora":
        raise NotImplementedError(f"--tune {args.tune} (projector tuning) "
                                  f"{_QUEUED}")
    if args.video_folder:
        raise NotImplementedError(f"--video_folder {_QUEUED}")
    if args.template != "llama_3":
        raise NotImplementedError(f"--template {args.template} {_QUEUED}")


def to_unit_pixels(pixels) -> torch.Tensor:
    """uint8 [0, 255] image array -> float32 [0, 1] (what normalize_pixels
    takes)."""
    return torch.as_tensor(np.asarray(pixels), dtype=torch.float32) / 255.0


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


def _image_fns(args, cap):
    """(process_image, feats_fn) for the captioner's tower and projector."""
    from PIL import Image
    from .models.vlm.anyres import expand2square
    size = cap.vision.cfg.image_size
    dev, dt = cap.image_newline.device, cap.image_newline.dtype
    if args.image_aspect_ratio == "anyres":
        def process_image(path):
            return Image.open(path).convert("RGB")

        def feats_fn(image):  # PIL -> [T(image), D] anyres stream
            return anyres_image_features(cap.vision, cap.projector, image,
                                         cap.image_newline, size)
        return process_image, feats_fn
    bg = tuple(int(255 * m) for m in CLIP_MEAN)

    def process_image(path):
        img = expand2square(Image.open(path).convert("RGB"), bg)
        return np.asarray(img.resize((size, size), Image.BICUBIC))

    def feats_fn(pixels):  # [size, size, 3] uint8 -> [T, D]
        px = normalize_pixels(to_unit_pixels(pixels)[None].to(dev, dt))
        return cap.projector(cap.vision(px))[0]
    return process_image, feats_fn


def train(args, cap, *, encode, preprocess_kw=None, with_images=True,
          on_step=None):
    """The finetune loop on a built LlavaCaptioner (its decoder trains, on
    the captioner's device). Returns (result dict, the VLMTrainer).
    `on_step`, when given, gets each step's record (step, loss, seconds of
    the train step, batch, padded width)."""
    from .data.prefetch import worker_map
    refuse_unported(args)
    model = cap.llama
    model.cfg = dataclasses.replace(model.cfg, remat=args.gradient_checkpointing)
    device = cap.image_newline.device
    process_image = feats_fn = None
    if with_images:
        process_image, feats_fn = _image_fns(args, cap)
    ds = LazyConversationDataset(args.data_path, encode, template=args.template,
                                 image_folder=args.image_folder or "",
                                 process_image=process_image,
                                 preprocess_kw=preprocess_kw)
    trainer = VLMTrainer(model, LoraConfig(r=args.lora_r, alpha=args.lora_alpha),
                         lr=args.lr,
                         generator=torch.Generator().manual_seed(args.seed))

    def embed_fn(ids):
        return model.embed(torch.as_tensor(ids, dtype=torch.long,
                                           device=device))

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
            rows = []
            with torch.no_grad():
                for it in batch:
                    feats = (feats_fn(it["image"])
                             if "image" in it and feats_fn else None)
                    e, lab = splice_training_sample(
                        it["input_ids"], it["labels"], embed_fn, feats,
                        IGNORE_INDEX)
                    # truncate after the image splice, and refuse a row
                    # whose every supervised token was cut (loss 0)
                    lab = lab[:args.max_length]
                    if not (lab != IGNORE_INDEX).any():
                        raise SystemExit(
                            f"record {it.get('id')}: truncation to "
                            f"--max_length {args.max_length} removed every "
                            "supervised token; raise --max_length")
                    rows.append((e[:args.max_length], lab))
            width = max(e.shape[0] for e, _ in rows)
            width = -(-width // args.pad_to) * args.pad_to
            emb = torch.stack([F.pad(e, (0, 0, 0, width - e.shape[0]))
                               for e, _ in rows])
            lab = np.full((len(rows), width), IGNORE_INDEX, np.int64)
            for j, (_, lt) in enumerate(rows):
                lab[j, :len(lt)] = lt
            t0 = time.perf_counter()
            loss = trainer.train_step(emb, torch.from_numpy(lab).to(device))
            step_s.append(time.perf_counter() - t0)  # float(loss) synced
            losses.append(loss)
            step += 1
            if on_step is not None:
                on_step(dict(step=step, loss=loss, seconds=step_s[-1],
                             batch=len(rows), width=width))
            if step % 10 == 0 or step == 1:
                print(f"step {step} epoch {epoch} loss {loss:.4f}", flush=True)
            if args.save_every and step % args.save_every == 0:
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
    save_lora_npz(trainer.lora, trainer.lora_cfg, out / "lora_final.npz")
    res = {"steps": step, "first_loss": float(losses[0]),
           "final_loss": float(losses[-1]), "step_s": step_s,
           "adapters": str(out / "lora_final.npz")}
    return res, trainer


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    from .models.vlm.captioner import LlavaCaptioner
    device = resolve_device(args.device)
    dtype = compute_dtype(device)
    quant = {16: None, 8: "int8", 4: "int4"}[args.bits]
    if args.smoke:
        cap = LlavaCaptioner.seeded(SMOKE_LLAMA, SMOKE_VISION, HashTokenizer(),
                                    quant=quant, device=device, dtype=dtype)
        encode, pre_kw, with_images = _hash_encode, {"sp": SMOKE_SPECIAL}, False
    else:
        cap = LlavaCaptioner.load(args.ckpt_dir, quant=quant, device=device,
                                  dtype=dtype)
        if cap is None:
            sys.exit(f"no checkpoint under {args.ckpt_dir}/llava — pass "
                     "--smoke for a random tiny model")
        encode = lambda s: cap.tokenizer.encode(s, add_special_tokens=False)
        pre_kw, with_images = {}, True
    res, _ = train(args, cap, encode=encode, preprocess_kw=pre_kw,
                   with_images=with_images)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
