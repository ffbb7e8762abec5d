"""Datasets for SR3 training and inference, host side in numpy and PIL
(rsvldm_tpu/data/datasets.py, the port's own copy): the single-image
bicubic-up input, the lr / sr / hr triplet trees of an image folder or an
lmdb, and their joint flip / rotation augmentation. Arrays are HWC float32
in [-1, 1]."""

from __future__ import annotations

import io
import random
from pathlib import Path

import numpy as np
from PIL import Image

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}


def _to_pm1(img) -> np.ndarray:
    x = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (x - 0.5) / 0.5


def augment(arrays: list, hflip: bool = True, rot: bool = False,
            rng: random.Random | None = None):
    """The same horizontal flip (and, with rot, vertical flip and
    transpose) for every array of a triplet; decisions drawn from `rng`
    (default: the `random` module) in JAX's order."""
    rng = rng or random
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5
    out = []
    for a in arrays:
        if do_h:
            a = a[:, ::-1, :]
        if do_v:
            a = a[::-1, :, :]
        if do_r:
            a = a.transpose(1, 0, 2)
        out.append(np.ascontiguousarray(a))
    return out


class SingleImageDataset:
    """One image -> bicubic x upscale, centre crop, [-1, 1]."""

    def __init__(self, path: str, upscale: int):
        self.path = path
        self.upscale = upscale

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        from ..ops.image import load_lr_conditioning
        return {"SR": load_lr_conditioning(self.path, self.upscale)}


class LRHRDataset:
    """<root>/hr_{r}/, sr_{l}_{r}/ and lr_{l}/ with one file name per
    sample: (HR, SR bicubic[, LR]) arrays, flipped together in the train
    split."""

    def __init__(self, root: str, l_res: int, r_res: int, split: str = "train",
                 data_len: int = -1, need_lr: bool = False, hflip: bool = True):
        root = Path(root)
        self.hr_dir = root / f"hr_{r_res}"
        self.sr_dir = root / f"sr_{l_res}_{r_res}"
        self.lr_dir = root / f"lr_{l_res}"
        self.need_lr = need_lr
        self.split = split
        self.hflip = hflip and split == "train"
        names = sorted(p.name for p in self.hr_dir.iterdir()
                       if p.suffix.lower() in IMG_EXTS)
        self.names = names[:data_len] if data_len > 0 else names

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        return self.getitem_rng(idx, None)

    def getitem_rng(self, idx, rng):
        """__getitem__ with an explicit augmentation RNG (make_loader keys
        one per (seed, epoch, index)); None draws from `random`."""
        name = self.names[idx]
        arrays = [_to_pm1(Image.open(self.hr_dir / name)),
                  _to_pm1(Image.open(self.sr_dir / name))]
        if self.need_lr:
            arrays.append(_to_pm1(Image.open(self.lr_dir / name)))
        if self.hflip:
            arrays = augment(arrays, hflip=True, rng=rng)
        return tuple(arrays)

    def batches(self, batch_size: int, rng: random.Random | None = None,
                drop_last: bool = True):
        """Endless shuffled batches of stacked columns."""
        rng = rng or random.Random(0)
        order = list(range(len(self)))
        while True:
            rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[j] for j in order[i:i + batch_size]]
                yield tuple(np.stack(col) for col in zip(*items))


class LmdbLRHRDataset:
    """The triplets in an lmdb: keys 'hr_{r}_{idx:05d}', 'sr_{l}_{r}_{idx:05d}'
    and 'lr_{l}_{idx:05d}' holding encoded images, and 'length'. `env` is
    an lmdb.Environment-like object (.begin() gives a context manager with
    .get(bytes)) or a path, which needs the lmdb package."""

    def __init__(self, env, l_res: int, r_res: int, split: str = "train",
                 data_len: int = -1, need_lr: bool = False, hflip: bool = True):
        if isinstance(env, (str, Path)):
            try:
                import lmdb
            except ImportError as e:
                raise ImportError(
                    "lmdb backend requested but the lmdb package is not "
                    "installed; pass an env-like object or use LRHRDataset "
                    "(image-dir backend)") from e
            env = lmdb.open(str(env), readonly=True, lock=False,
                            readahead=False, meminit=False)
        self.env = env
        self.l_res = l_res
        self.r_res = r_res
        self.need_lr = need_lr
        self.hflip = hflip and split == "train"
        with self.env.begin() as txn:
            n = int(txn.get(b"length"))
        self.data_len = n if data_len <= 0 else min(data_len, n)

    def __len__(self):
        return self.data_len

    @staticmethod
    def _decode(raw: bytes):
        return _to_pm1(Image.open(io.BytesIO(raw)).convert("RGB"))

    def __getitem__(self, idx: int):
        return self.getitem_rng(idx, None)

    def getitem_rng(self, idx: int, rng):
        key = str(idx).zfill(5)
        with self.env.begin() as txn:
            hr = txn.get(f"hr_{self.r_res}_{key}".encode())
            sr = txn.get(f"sr_{self.l_res}_{self.r_res}_{key}".encode())
            lr = (txn.get(f"lr_{self.l_res}_{key}".encode())
                  if self.need_lr else None)
        if hr is None or sr is None or (self.need_lr and lr is None):
            raise KeyError(f"missing lmdb record for index {idx}")
        arrays = [self._decode(hr), self._decode(sr)]
        if self.need_lr:
            arrays.append(self._decode(lr))
        if self.hflip:
            arrays = augment(arrays, hflip=True, rng=rng)
        return tuple(arrays)
