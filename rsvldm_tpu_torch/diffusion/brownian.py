"""Brownian-tree noise sampler (rsvldm_tpu/diffusion/brownian.py).

`noise_sampler(sigma, sigma_next)` returns the increment of one fixed
Brownian path W over [sigma, sigma_next], normalized to unit variance:
(W(t1) - W(t0)) / sqrt(|t1 - t0|). W(t) is a pure function of the key and
t, JAX's brownian_point: k_end, k_tree = split(key); W(t1) is
sqrt(t1 - t0) times the normals of k_end; then a fixed-depth dyadic
descent of Lévy-bridge midpoints, the normals of node (level, index) drawn
from fold_in(fold_in(k_tree, level), index) (utils/prng.py, JAX's
numbers); then linear interpolation inside the leaf. Increments are
exactly additive and the result does not depend on the order of queries.

The descent's scalars (the interval ends, the midpoints, the branch taken,
the interpolation weight, so the node indices) are float32 values worked
out on the host, as JAX's traced float32 arithmetic gives them; a point is
then one draw of depth + 1 rows (the end point and the path's nodes) on
the key's device, one threefry launch on the card, and their sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils import prng

DEPTH = 24
f32 = np.float32


def brownian_point(key: prng.Key, t, t0, t1, shape, depth: int = DEPTH,
                   device="cpu") -> torch.Tensor:
    """W(t) for a standard Brownian path on [t0, t1] with W(t0) = 0 (JAX's
    brownian_point of `key`): the end draw, `depth` levels of conditional
    midpoints, linear interpolation inside the final leaf. fp32 on
    `device`."""
    lo, hi = f32(t0), f32(t1)
    t = min(max(f32(t), lo), hi)
    a, b, idx, nodes = lo, hi, 0, []
    for level in range(depth):
        m = f32(f32(0.5) * f32(a + b))
        right = bool(t >= m)
        nodes.append((idx, float(f32(0.5) * np.sqrt(f32(b - a))), right))
        a, b = (m, b) if right else (a, m)
        idx = 2 * idx + int(right)
    frac = f32(f32(t - a) / f32(b - a)) if b > a else f32(0.0)
    k_end, k_tree = prng.split(key)
    rows = [(k_end, None)] + [(prng.fold_in(k_tree, level), i)
                              for level, (i, _, _) in enumerate(nodes)]
    z = prng.draw(rows, tuple(shape), "normal", torch.float32, device)
    wb = float(np.sqrt(f32(t1 - t0))) * z[0]
    wa = torch.zeros_like(wb)
    for level, (_, half_sd, right) in enumerate(nodes):
        # W(m) | W(a), W(b) ~ N((wa + wb) / 2, (b - a) / 4)
        wm = 0.5 * (wa + wb) + half_sd * z[level + 1]
        if right:
            wa = wm
        else:
            wb = wm
    return wa + float(frac) * (wb - wa)


class BrownianTreeNoiseSampler:
    """`sampler(sigma, sigma_next)` -> unit-variance increment noise over
    one Brownian path on [sigma_min, sigma_max]; `w(t)` is the path's
    value. key: the path's utils/prng key (default PRNGKey(0), as JAX's
    samplers default their rng); the draws land on `device`, the card
    unless device="cpu"."""

    def __init__(self, sigma_min, sigma_max, shape,
                 key: prng.Key | None = None, device=None,
                 depth: int = DEPTH):
        self.t0 = float(sigma_min)
        self.t1 = float(sigma_max)
        self.shape = tuple(shape)
        self.key = prng.key(0) if key is None else key
        self.device = resolve_device(device)
        self.depth = depth

    def w(self, t) -> torch.Tensor:
        return brownian_point(self.key, t, self.t0, self.t1, self.shape,
                              self.depth, self.device)

    def __call__(self, sigma, sigma_next) -> torch.Tensor:
        dw = self.w(sigma_next) - self.w(sigma)
        dt = abs(f32(f32(sigma_next) - f32(sigma)))
        return dw / float(np.sqrt(max(dt, f32(1e-20))))
