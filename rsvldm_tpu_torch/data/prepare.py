"""Offline bicubic triplets (rsvldm_tpu/data/prepare.py): each source image
centre-cropped to a square, bicubic-resized to r_res (hr_{r}/), down to
l_res (lr_{l}/) and back up to r_res (sr_{l}_{r}/) with PIL, as the
reference's data/prepare_data.py builds SR3's training trees. Threads over
the images."""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path

from PIL import Image

from .datasets import IMG_EXTS


def _process_one(src: Path, out_root: Path, l_res: int, r_res: int) -> str:
    img = Image.open(src).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2,
                    (w - s) // 2 + s, (h - s) // 2 + s))
    hr = img.resize((r_res, r_res), Image.BICUBIC)
    lr = hr.resize((l_res, l_res), Image.BICUBIC)
    sr = lr.resize((r_res, r_res), Image.BICUBIC)
    hr.save(out_root / f"hr_{r_res}" / src.name)
    lr.save(out_root / f"lr_{l_res}" / src.name)
    sr.save(out_root / f"sr_{l_res}_{r_res}" / src.name)
    return src.name


def prepare_triplets(src_dir: str, out_dir: str, l_res: int = 28,
                     r_res: int = 224, workers: int = 8) -> list[str]:
    """Build the hr_{r}/, lr_{l}/ and sr_{l}_{r}/ trees under out_dir from
    the images of src_dir; returns their names, sorted."""
    src, out = Path(src_dir), Path(out_dir)
    for d in (f"hr_{r_res}", f"lr_{l_res}", f"sr_{l_res}_{r_res}"):
        (out / d).mkdir(parents=True, exist_ok=True)
    images = sorted(p for p in src.iterdir() if p.suffix.lower() in IMG_EXTS)
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda p: _process_one(p, out, l_res, r_res), images))
