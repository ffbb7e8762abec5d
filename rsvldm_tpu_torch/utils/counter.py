"""Counter-based draws: numbers that are a pure function of integer keys,
computed with int64 tensor ops on the tensor's device. No generator state,
so the same key gives the same draw in any order of queries, and a captured
CUDA graph replays them. Used by the serving engine's sampling noise and the
Brownian tree's node draws."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mix(x: int | torch.Tensor) -> int | torch.Tensor:
    """A 32-bit integer hash of values in [0, 2^32), a Python int or an
    int64 tensor: xor-shifts and multiplies by constants below 2^31, so no
    product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & M32
    return x ^ (x >> 16)


def unit(x: torch.Tensor) -> torch.Tensor:
    """The top 24 bits of a 32-bit hash as a uniform in (0, 1), fp32."""
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
