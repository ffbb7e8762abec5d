"""Host-side image preparation (rsvldm_tpu/ops/image.py), HWC numpy float32
in [-1, 1]. Resampling goes through PIL; the JAX package's native resampler
is not carried over."""

from __future__ import annotations

import numpy as np
from PIL import Image


def round_to_multiple(x: float, m: int = 64) -> int:
    return int(np.round(x / float(m))) * m


def pil_to_array(img, upscale: float = 1, min_size: int = 1024,
                 fix_resize: int | None = None, unit: int = 64):
    """PIL.Image -> (float32 [H, W, 3] in [-1, 1], h0, w0): scale by
    `upscale`, enforce `min_size` on the short side, round H and W to
    multiples of `unit`, bicubic resample. h0/w0 are the sizes before
    rounding, to which the final output is resized back."""
    w, h = img.size
    w *= upscale
    h *= upscale
    w0, h0 = round(w), round(h)
    if min(w, h) < min_size:
        s = min_size / min(w, h)
        w *= s
        h *= s
    if fix_resize is not None:
        s = fix_resize / min(w, h)
        w *= s
        h *= s
        w0, h0 = round(w), round(h)
    w = round_to_multiple(w, unit)
    h = round_to_multiple(h, unit)
    x = img.convert("RGB").resize((w, h), Image.BICUBIC)
    x = np.asarray(x).round().clip(0, 255).astype(np.uint8)
    return x.astype(np.float32) / 255.0 * 2.0 - 1.0, h0, w0


def _torch_cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] resample matrix of torch F.interpolate(mode='bicubic',
    align_corners=False, antialias=False): A = -0.75, half-pixel centres,
    clamped border taps."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    A = -0.75

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1, ((A + 2) * x - (A + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * A, 0.0))

    w = np.zeros((out_size, in_size), np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), idx), k(frac - tap))
    return w.astype(np.float32)


def resize_bicubic_torch(x, size: tuple[int, int]) -> np.ndarray:
    """NHWC float32 resize with the torch-bicubic matrices, on the host."""
    x = np.asarray(x, np.float32)
    h_in, w_in = x.shape[1], x.shape[2]
    if (h_in, w_in) == tuple(size):
        return x
    wh = _torch_cubic_matrix(h_in, size[0])
    ww = _torch_cubic_matrix(w_in, size[1])
    y = np.einsum("oh,nhwc->nowc", wh, x, optimize=True)
    return np.einsum("pw,nowc->nopc", ww, y, optimize=True)


def array_to_pil(x: np.ndarray, h0: int | None = None, w0: int | None = None):
    """[H, W, 3] float in [-1, 1] -> PIL.Image, bicubic-resized to (h0, w0)
    when given and different."""
    x = np.asarray(x)
    if h0 is not None and w0 is not None and (x.shape[0] != h0 or x.shape[1] != w0):
        x = resize_bicubic_torch(x[None], (h0, w0))[0]
    x = (x * 127.5 + 127.5).clip(0, 255).astype(np.uint8)
    return Image.fromarray(x)


def to_uint8(x: np.ndarray, min_max=(-1.0, 1.0)) -> np.ndarray:
    """[H, W, C] float -> uint8 (round to nearest)."""
    x = np.asarray(x, dtype=np.float32)
    x = (np.clip(x, *min_max) - min_max[0]) / (min_max[1] - min_max[0])
    return (x * 255.0).round().astype(np.uint8)


def load_lr_conditioning(path: str, upscale: int) -> np.ndarray:
    """Stage-1 input: bicubic upsample by `upscale` (short side to
    max(w, h) * upscale, long side truncated), centre crop, [-1, 1].
    Returns float32 [H, W, 3]."""
    img = Image.open(path).convert("RGB")
    w, h = img.size
    target = max(w, h) * upscale
    if w < h:
        nw, nh = target, int(h * target / w)
    else:
        nh, nw = target, int(w * target / h)
    img = img.resize((nw, nh), Image.BICUBIC)
    left = int(round((nw - target) / 2.0))
    top = int(round((nh - target) / 2.0))
    img = img.crop((left, top, left + target, top + target))
    x = np.asarray(img).astype(np.float32) / 255.0
    return (x - 0.5) / 0.5
