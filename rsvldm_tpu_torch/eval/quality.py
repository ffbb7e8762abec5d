"""Folder-level quality evaluation (rsvldm_tpu/eval/quality.py): CLIP-IQA,
SMS, PSNR, SSIM and LPIPS of a folder of SR outputs, paired with an HR
folder by stem, printed as one JSON line. It makes the reference's quality
table executable (CLIP-IQA up, SMS down).

Assets under --ckpt_dir: clip/ holds a whole HF CLIPModel checkpoint
(*.safetensors or pytorch_model*.bin with text_model.*, vision_model.* and
both projections, plus config.json for the head counts), its tokenizer
(vocab.json + merges.txt) in clip_vocab/ or clip/ itself; lpips/ holds
vgg16.pth (torchvision names) and lpips_vgg.pth (the LPIPS heads). A
metric whose assets are absent is skipped. The towers and LPIPS run in
fp32 on the card (TF32 off) unless device="cpu" is asked for.
"""

from __future__ import annotations

import glob
import json
import logging
import re
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device

log = logging.getLogger("rsvldm_torch")

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_images(d: Path) -> list[Path]:
    return sorted(p for p in d.iterdir() if p.suffix.lower() in IMG_EXTS)


def _strip_suffixes(stem: str) -> str:
    """An output file's source stem: X_final_<i> -> X for any sample index,
    sr3_X -> X, then X_final / X_sr3 -> X (the folder CLI's naming)."""
    if stem.startswith("sr3_"):
        stem = stem[len("sr3_"):]
    m = re.fullmatch(r"(.+)_final_\d+", stem)
    if m:
        return m.group(1)
    for suf in ("_final", "_sr3"):
        if stem.endswith(suf):
            return stem[: -len(suf)]
    return stem


def _layers(sd: dict, prefix: str) -> int:
    return 1 + max(int(k.split(".")[3]) for k in sd if k.startswith(prefix))


def build_clip_scorer(ckpt_dir: str | Path, device=None):
    """A CLIPScorer over the HF CLIPModel checkpoint in <ckpt_dir>/clip, on
    `device` (the card unless "cpu"), or None when the weights, the text
    tower or the tokenizer files are absent. Geometry comes from the
    weights (the input size from the position table) and the head counts
    from config.json. Images are bicubic-resized on the host to the CLIP
    square and CLIP-normalized (the torchmetrics CLIP-IQA protocol)."""
    from ..models.text.clip import CLIPTextConfig, CLIPTextTransformer
    from ..models.vlm.vision import (CLIPVisionConfig, CLIPVisionEmbedder,
                                     normalize_pixels)
    from ..ops.image import resize_bicubic_torch
    from ..utils.checkpoint import load_checked, load_torch_state_dict
    from ..utils.metrics import CLIPScorer
    from ..utils.tokenizer import CLIPTokenizer

    d = Path(ckpt_dir) / "clip"
    if not d.is_dir():
        return None
    sd: dict = {}
    for shard in sorted(glob.glob(str(d / "*.safetensors"))) or \
            sorted(glob.glob(str(d / "pytorch_model*.bin"))):
        sd.update(load_torch_state_dict(shard))
    if not any(k.startswith("vision_model.") for k in sd):
        return None
    if not any(k.startswith("text_model.encoder.layers.") for k in sd):
        log.warning("CLIP checkpoint under %s has no text tower: CLIP-IQA "
                    "and SMS need a whole CLIPModel export", d)
        return None
    tok_dir = Path(ckpt_dir) / "clip_vocab"
    try:
        tokenizer = CLIPTokenizer.from_dir(str(tok_dir if tok_dir.is_dir() else d))
    except FileNotFoundError as e:
        log.warning("CLIP tokenizer assets absent (%s): CLIP-IQA and SMS "
                    "skipped", e)
        return None

    hf_cfg = {}
    cfg_json = d / "config.json"
    if cfg_json.exists():
        hf_cfg = json.loads(cfg_json.read_text())
    width = sd["vision_model.embeddings.class_embedding"].shape[0]
    patch = sd["vision_model.embeddings.patch_embedding.weight"].shape[-1]
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    img_size = patch * int(round((n_pos - 1) ** 0.5))
    heads = hf_cfg.get("vision_config", {}).get("num_attention_heads",
                                                width // 64)
    if not cfg_json.exists():
        log.warning("no config.json under %s: assuming head_dim 64 for the "
                    "CLIP towers", d)
    vcfg = CLIPVisionConfig(image_size=img_size, patch_size=patch, width=width,
                            layers=_layers(sd, "vision_model.encoder.layers."),
                            heads=heads)
    tok_emb = sd["text_model.embeddings.token_embedding.weight"]
    t_width = tok_emb.shape[1]
    tcfg = CLIPTextConfig(
        vocab_size=tok_emb.shape[0], width=t_width,
        layers=_layers(sd, "text_model.encoder.layers."),
        heads=hf_cfg.get("text_config", {}).get("num_attention_heads",
                                                t_width // 64),
        context_length=sd["text_model.embeddings.position_embedding.weight"].shape[0],
        use_text_projection=True,
        projection_dim=sd["text_projection.weight"].shape[0])

    dev = resolve_device(device)
    vision = CLIPVisionEmbedder(vcfg, projection_dim=sd["visual_projection.weight"].shape[0])
    text = CLIPTextTransformer(tcfg)
    for name, m in (("clip vision", vision), ("clip text", text)):
        load_checked(m, sd, name)
        m.to(dev).eval().requires_grad_(False)

    @torch.no_grad()
    def vision_embed(images01):
        """[N, H, W, 3] in [0, 1] -> [N, proj] image embeds; the resize to
        the CLIP square on the host, the tower on the device."""
        x = images01.cpu().numpy() if isinstance(images01, torch.Tensor) \
            else np.asarray(images01)
        x = resize_bicubic_torch(x, (img_size, img_size))
        return vision(normalize_pixels(torch.from_numpy(x).to(dev)))

    @torch.no_grad()
    def text_embed(tokens):
        return text(tokens.to(dev))["pooled"]

    return CLIPScorer(vision_embed, text_embed, tokenizer)


def _read01(p: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0


def evaluate_dir(sr_dir: str | Path, hr_dir: str | Path | None = None,
                 ckpt_dir: str | Path | None = None, scorer=None, lpips=None,
                 device=None) -> dict:
    """Score every image of sr_dir; pair it with hr_dir's image of the
    same stripped stem for the full-reference metrics (the SR image
    bicubic-resized to the HR grid when the sizes differ). Returns the
    means plus per-image records under "images". Runs on `device` (the
    card unless "cpu")."""
    from ..ops.image import resize_bicubic_torch
    from ..utils import metrics as M

    dev = resolve_device(device)
    sr_dir = Path(sr_dir)
    srs = _list_images(sr_dir)
    if not srs:
        raise FileNotFoundError(f"no images under {sr_dir}")
    hr_by_stem = {}
    if hr_dir is not None:
        hr_by_stem = {p.stem: p for p in _list_images(Path(hr_dir))}
    if scorer is None and ckpt_dir is not None:
        scorer = build_clip_scorer(ckpt_dir, dev)
        if scorer is None:
            log.warning("CLIP assets absent under %s/clip: CLIP-IQA and SMS "
                        "skipped", ckpt_dir)
    if lpips is None and ckpt_dir is not None:
        lpips = M.load_lpips(ckpt_dir, dev)

    per_image = []
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)[None]
    with torch.no_grad():
        for p in srs:
            sr = _read01(p)
            rec: dict = {"image": p.name}
            hr_p = hr_by_stem.get(_strip_suffixes(p.stem))
            if scorer is not None:
                rec["CLIP-IQA"] = float(scorer.clip_iqa(on(sr))[0])
            if hr_p is not None:
                hr = _read01(hr_p)
                sr_m = sr
                if sr.shape != hr.shape:  # at the HR grid, torch bicubic
                    sr_m = resize_bicubic_torch(sr[None], hr.shape[:2])[0]
                rec["PSNR"] = float(M.psnr(on(sr_m), on(hr)))
                rec["SSIM"] = float(M.ssim(on(sr_m), on(hr)))
                if scorer is not None:
                    rec["SMS"] = float(scorer.sms(on(sr), on(hr))[0])
                if lpips is not None:
                    rec["LPIPS"] = float(torch.mean(lpips(on(sr_m * 2 - 1),
                                                          on(hr * 2 - 1))))
            per_image.append(rec)

    agg: dict = {"num_images": len(per_image)}
    for key in ("CLIP-IQA", "SMS", "PSNR", "SSIM", "LPIPS"):
        vals = [r[key] for r in per_image if key in r]
        if vals:
            agg[key] = float(np.mean(vals))
    agg["images"] = per_image
    return agg


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Quality harness: CLIP-IQA / SMS / PSNR / SSIM / LPIPS "
                    "over a folder of SR outputs; prints one JSON line.")
    ap.add_argument("--sr_dir", required=True)
    ap.add_argument("--hr_dir", default=None)
    ap.add_argument("--ckpt_dir", default="./CKPT_PTH")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    res = evaluate_dir(args.sr_dir, args.hr_dir, args.ckpt_dir,
                       device=args.device)
    print(json.dumps({k: v for k, v in res.items() if k != "images"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res
