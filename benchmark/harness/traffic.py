"""The tile generator of the image mixes: a mix file gives the tile side
and the tile's kind; request i's tile is drawn from (seed, i) alone, so
the same seed gives the same tiles and every seed the same sizes. Kinds:
"fields", a remote-sensing-like tile of smooth random fields
(low-frequency colour patches with fine texture)."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
from PIL import Image


def request_seed(seed: int, index: int) -> int:
    h = hashlib.sha256(f"tile/{int(seed)}/{int(index)}".encode()).digest()
    return int.from_bytes(h[:8], "little")


def tile(mix: dict, seed: int, index: int) -> np.ndarray:
    """uint8 [side, side, 3] of request `index`."""
    rng = np.random.default_rng(request_seed(seed, index))
    side = int(mix["tile_side"])
    if mix.get("kind", "fields") != "fields":
        raise ValueError(f"traffic kind {mix['kind']!r}")
    coarse = rng.uniform(0, 255, (max(side // 7, 2), max(side // 7, 2), 3))
    base = np.asarray(Image.fromarray(coarse.astype(np.uint8)).resize(
        (side, side), Image.BICUBIC), np.float32)
    fine = rng.normal(0.0, float(mix.get("texture", 12.0)), (side, side, 3))
    return np.clip(base + fine, 0, 255).astype(np.uint8)


def write_tile(mix: dict, seed: int, index: int, out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"tile_{index:04d}.png"
    Image.fromarray(tile(mix, seed, index)).save(path)
    return path
