"""sgm's auxiliary embedders (rsvldm_tpu/models/text/embedders.py):
ClassEmbedder, SpatialRescaler, LowScaleEncoder, gaussian_encode,
ImageEmbedder and byt5_tokenize. Layouts are JAX's: images NHWC.

LowScaleEncoder and gaussian_encode draw JAX's numbers from a `key` (a
utils/prng key, default PRNGKey(0)): the encoder's split, then randint
noise levels and normals; the posterior's normals. Both also take the
draws as arguments (`t`, `noise`). SpatialRescaler
resizes as jax.image.resize does (linear and cubic antialiased when they
shrink, nearest by JAX's index rule: `_jax_resize`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ...utils import prng


class ClassEmbedder(nn.Module):
    """A class-label vector (`embedding.weight`); class n_classes - 1 is the
    unconditional one."""

    def __init__(self, embed_dim: int, n_classes: int = 1000,
                 add_sequence_dim: bool = False):
        super().__init__()
        self.n_classes, self.add_sequence_dim = n_classes, add_sequence_dim
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        e = self.embedding(c)
        return e[:, None, :] if self.add_sequence_dim else e

    def unconditional_class(self) -> int:
        return self.n_classes - 1


def _keys_cubic(x):
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out)


def _resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[out, in] fp32 matrix of jax.image.resize along one axis: nearest
    takes input floor((i + 0.5) * in / out); linear and cubic (Keys, a =
    -0.5) weigh half-pixel centres with the kernel widened by in / out when
    shrinking (antialias), normalized to sum 1 (jax.image.scale_and_translate)."""
    f = np.float32
    if method == "nearest":
        idx = np.floor((np.arange(out_size, dtype=f) + f(0.5)) * f(in_size)
                       / f(out_size)).astype(np.int64)
        m = np.zeros((out_size, in_size), f)
        m[np.arange(out_size), np.minimum(idx, in_size - 1)] = 1.0
        return m
    kernel = {"linear": lambda x: np.maximum(f(0.0), f(1.0) - np.abs(x)),
              "cubic": _keys_cubic}[method]
    inv = f(1.0 / (out_size / in_size))
    kscale = np.maximum(inv, f(1.0))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / kscale
    w = kernel(x).astype(f)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f(0.0)).T.astype(f)


def _jax_resize(x: torch.Tensor, size: tuple, method: str) -> torch.Tensor:
    """x [N, H, W, C] resized to `size` (h, w) as jax.image.resize does, in
    fp32, cast back."""
    out = x.float()
    for d, n in zip((1, 2), size):
        if out.shape[d] == n:
            continue
        m = torch.from_numpy(_resize_matrix(out.shape[d], n, method))
        out = torch.tensordot(out.movedim(d, -1), m.to(out.device).t(),
                              dims=1).movedim(-1, d)
    return out.to(x.dtype)


class SpatialRescaler(nn.Module):
    """n_stages resizes by `multiplier` (torch interpolate's mode names),
    then optionally a `channel_mapper` conv from in_channels to
    out_channels. NHWC in and out."""

    _METHODS = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
                "bicubic": "cubic"}

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None, kernel_size: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.n_stages, self.multiplier = n_stages, multiplier
        self.method = self._METHODS[method]
        self.channel_mapper = (None if out_channels is None else nn.Conv2d(
            in_channels, out_channels, kernel_size, padding=kernel_size // 2,
            bias=use_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            h, w = x.shape[1:3]
            x = _jax_resize(x, (int(h * self.multiplier),
                                int(w * self.multiplier)), self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x


@dataclasses.dataclass
class LowScaleEncoder:
    """Noise-augmented low-res conditioning (JAX LowScaleEncoder): encode,
    scale, q_sample at random noise levels with random normals, nearest
    resize to out_size."""
    encode_fn: Callable
    betas: torch.Tensor
    max_noise_level: int = 250
    out_size: Optional[int] = 64
    scale_factor: float = 1.0

    def __post_init__(self):
        a = torch.cumprod(1.0 - torch.as_tensor(self.betas, dtype=torch.float32), 0)
        self.sqrt_ac = torch.sqrt(a)
        self.sqrt_1mac = torch.sqrt(1.0 - a)

    def q_sample(self, z, t, noise):
        shape = (-1,) + (1,) * (z.dim() - 1)
        dev = z.device
        return (self.sqrt_ac.to(dev)[t].reshape(shape) * z
                + self.sqrt_1mac.to(dev)[t].reshape(shape) * noise)

    def __call__(self, x: torch.Tensor, t: torch.Tensor | None = None,
                 noise: torch.Tensor | None = None,
                 key: prng.Key | None = None):
        """x [N, H, W, C] -> (z, t). t [N] noise levels in [0,
        max_noise_level) and noise (unit normals of the latent's shape) are
        JAX's draws of `key` (split: randint, then normal) unless given."""
        z = self.encode_fn(x) * self.scale_factor
        k1, k2 = prng.split(prng.key(0) if key is None else key)
        if t is None:
            t = prng.randint(k1, (x.shape[0],), 0, self.max_noise_level,
                             z.device)
        if noise is None:
            noise = prng.normal(k2, tuple(z.shape), _draw_dtype(z), z.device)
        z = self.q_sample(z, t.to(z.device), noise.to(z.device, z.dtype))
        if self.out_size is not None:
            z = _jax_resize(z, (self.out_size, self.out_size), "nearest")
        return z, t


def _draw_dtype(t: torch.Tensor) -> torch.dtype:
    ok = t.dtype in (torch.float32, torch.bfloat16)
    return t.dtype if ok else torch.float32


def gaussian_encode(encoder_apply: Callable, x: torch.Tensor,
                    noise: torch.Tensor | None = None,
                    flatten_output: bool = True, key: prng.Key | None = None):
    """GaussianEncoder: encoder moments [N, h, w, 2z] -> a posterior sample
    mean + std * noise (noise: unit normals [N, h, w, z], JAX's normals of
    `key` unless given) and the KL as the regularizer's loss:
    ({"kl_loss", "loss"}, z [N, h*w, z] or NHWC)."""
    moments = encoder_apply(x)
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = logvar.clamp(-30.0, 20.0)
    if noise is None:
        noise = prng.normal(prng.key(0) if key is None else key,
                            tuple(mean.shape), _draw_dtype(mean), mean.device)
    z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(dim=(1, 2, 3))
    log = {"kl_loss": kl.mean(), "loss": kl.mean()}
    if flatten_output:
        n, h, w, c = z.shape
        z = z.reshape(n, h * w, c)
    return log, z


@dataclasses.dataclass
class ImageEmbedder:
    """Pooled-CLIP image conditioning (FrozenOpenCLIPImageEmbedder's
    contract): images in [-1, 1] -> (x + 1) / 2, CLIP-normalized, the
    tower, the CLS row (or the token mean), ucg rows zeroed, repeated to
    `repeat_to_max_len`."""
    vision_apply: Callable
    pool: str = "cls"
    repeat_to_max_len: int = 0

    MEAN = (0.48145466, 0.4578275, 0.40821073)
    STD = (0.26862954, 0.26130258, 0.27577711)

    def __call__(self, images: torch.Tensor, ucg_mask=None) -> torch.Tensor:
        x = (images + 1.0) / 2.0
        mean = torch.tensor(self.MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.STD, dtype=x.dtype, device=x.device)
        tokens = self.vision_apply((x - mean) / std)
        emb = tokens[:, 0] if self.pool == "cls" else tokens.mean(dim=1)
        if ucg_mask is not None:
            emb = emb * torch.as_tensor(ucg_mask, device=emb.device)[:, None].to(emb.dtype)
        if self.repeat_to_max_len:
            return emb[:, None].repeat(1, self.repeat_to_max_len, 1)
        return emb


def byt5_tokenize(text: str, max_length: int = 77) -> torch.Tensor:
    """ByT5's byte ids: UTF-8 bytes + 3 (0-2 are pad, eos, unk), eos-ended,
    padded to max_length: [1, max_length] long."""
    ids = [b + 3 for b in text.encode("utf-8")][: max_length - 1] + [1]
    ids = ids + [0] * (max_length - len(ids))
    return torch.tensor(ids, dtype=torch.long)[None]
