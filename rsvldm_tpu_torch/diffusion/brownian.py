"""Brownian-tree noise sampler (rsvldm_tpu/diffusion/brownian.py).

`noise_sampler(sigma, sigma_next)` returns the increment of one fixed
Brownian path W over [sigma, sigma_next], normalized to unit variance:
(W(t1) - W(t0)) / sqrt(|t1 - t0|). W(t) is a pure function of the draw
source and t: a fixed-depth dyadic descent of Lévy-bridge midpoints, the
normal of each midpoint drawn by `draw(level, index, shape)` keyed by its
level and dyadic index (level -1, index 0 is the end point W(t1)), then
linear interpolation inside the leaf. Increments are exactly additive and
the result does not depend on the order of queries.

The descent's scalars (the interval ends, the midpoints, the branch taken,
the interpolation weight) are float32 values worked out on the host, as
JAX's traced float32 arithmetic gives them; only the draws and their sums
are tensors. The JAX package keys its draws by
fold_in(fold_in(k_tree, level), index), which torch cannot reproduce: the
tests inject JAX's draws, and the default source here is `CounterDraws`, a
counter hash that is pure in (seed, level, index).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..utils.counter import M32, mix, unit

DEPTH = 24
f32 = np.float32


class CounterDraws:
    """Unit normals pure in (seed, level, dyadic index, element): two
    24-bit counter-hash uniforms an element, Box-Muller, computed with
    integer tensor ops on `device` (the card unless "cpu"). No state: any
    order of queries gives the same draws."""

    _SALT = 0x3C6EF372

    def __init__(self, seed: int = 0, device=None):
        self.seed = seed
        self.device = resolve_device(device)

    def __call__(self, level: int, index: int, shape) -> torch.Tensor:
        key = mix((self.seed ^ self._SALT) & M32)
        key = mix(key ^ ((level + 1) & M32))
        key = mix(key ^ (index & M32))
        n = math.prod(shape)
        e = torch.arange(n, dtype=torch.long, device=self.device) * 2
        u1 = unit(mix(key ^ mix(e)))
        u2 = unit(mix(key ^ mix(e + 1)))
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)
        return z.reshape(shape)


def brownian_point(draw, t, t0, t1, shape, depth: int = DEPTH) -> torch.Tensor:
    """W(t) for a standard Brownian path on [t0, t1] with W(t0) = 0: the
    end draw, `depth` levels of conditional midpoints, linear
    interpolation inside the final leaf. fp32."""
    lo, hi = f32(t0), f32(t1)
    t = min(max(f32(t), lo), hi)
    wb = float(np.sqrt(f32(t1 - t0))) * draw(-1, 0, shape).float()
    wa = torch.zeros_like(wb)
    a, b, idx = lo, hi, 0
    for level in range(depth):
        m = f32(f32(0.5) * f32(a + b))
        z = draw(level, idx, shape).float()
        # W(m) | W(a), W(b) ~ N((wa + wb) / 2, (b - a) / 4)
        wm = 0.5 * (wa + wb) + float(f32(0.5) * np.sqrt(f32(b - a))) * z
        right = bool(t >= m)
        if right:
            a, wa = m, wm
        else:
            b, wb = m, wm
        idx = 2 * idx + int(right)
    frac = f32(f32(t - a) / f32(b - a)) if b > a else f32(0.0)
    return wa + float(frac) * (wb - wa)


class BrownianTreeNoiseSampler:
    """`sampler(sigma, sigma_next)` -> unit-variance increment noise over
    one Brownian path on [sigma_min, sigma_max]; `w(t)` is the path's
    value. draw: the source of the node normals, `draw(level, index,
    shape)`; by default `CounterDraws(0, device)`, on the card unless
    device="cpu"."""

    def __init__(self, sigma_min, sigma_max, shape, draw=None, device=None,
                 depth: int = DEPTH):
        self.t0 = float(sigma_min)
        self.t1 = float(sigma_max)
        self.shape = tuple(shape)
        self.draw = draw if draw is not None else CounterDraws(0, device)
        self.depth = depth

    def w(self, t) -> torch.Tensor:
        return brownian_point(self.draw, t, self.t0, self.t1, self.shape,
                              self.depth)

    def __call__(self, sigma, sigma_next) -> torch.Tensor:
        dw = self.w(sigma_next) - self.w(sigma)
        dt = abs(f32(f32(sigma_next) - f32(sigma)))
        return dw / float(np.sqrt(max(dt, f32(1e-20))))
