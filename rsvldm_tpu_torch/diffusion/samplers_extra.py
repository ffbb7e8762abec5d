"""The rest of the sgm sampler family (rsvldm_tpu/diffusion/samplers_extra.py):
EDM (+ Heun), Euler-ancestral, DPM++(2S) ancestral, DPM++(2M), linear
multistep, the substep sigma subset, the stochastic RestoreDPMPP2M, and the
tiled RestoreEDM / RestoreDPMPP2M over gaussian-weighted sliding latent
tiles.

Every sampler consumes a closure `denoise_fn(x, sigma) -> denoised` (CFG
inside) or, tiled, `denoise_tile_fn(tiles, sigma, lq_tiles)`; x is NHWC
fp32, sigma a 0-d fp32 tensor on x's device. The tiled samplers stack the
tiles on the batch axis: one denoiser call a step.

The JAX package runs each loop as a lax.scan, draws its noise in the loop
from fold_in(rng, i), and branches with lax.cond on sigma. Here the sigma
table is known on the host, so each step's scalars are worked out there
in float32 (as JAX's traced float32 arithmetic gives them) and each
branch is decided there, with no device read; the steps run eagerly. The
noise is JAX's, from `key` (a utils/prng key, default PRNGKey(0)): the
samplers that draw one normal a step take step i's from fold_in(key, i),
all the steps' rows in one draw before the loop over x's NHWC shape
(`eps=` [steps, *x.shape] injects them instead); the RestoreDPMPP2M pair
draws its Brownian tree's points from the key (`brownian.py`). The
sampler arithmetic is fp32 whatever the denoiser's dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils import prng
from .brownian import BrownianTreeNoiseSampler
from .samplers import init_noise_scaling, to_d
from .schedules import karras_sigmas, legacy_ddpm_sigmas

f32 = np.float32


def _host(sigmas) -> np.ndarray:
    if isinstance(sigmas, torch.Tensor):
        sigmas = sigmas.detach().cpu().numpy()
    return np.asarray(sigmas, np.float32)


def _call(fn, x: torch.Tensor, sigma, *extra) -> torch.Tensor:
    """The denoiser at a host sigma, its output in fp32."""
    s = torch.tensor(float(sigma), dtype=torch.float32, device=x.device)
    return fn(x, s, *extra).float()


def _step_normals(key: prng.Key | None, steps: int, x: torch.Tensor,
                 eps: torch.Tensor | None = None) -> torch.Tensor:
    """[steps, *x.shape] fp32 normals, row i JAX's normal(fold_in(key, i),
    x.shape) (key default PRNGKey(0)), in one draw on x's device; `eps`
    itself when given."""
    if eps is not None:
        return eps
    k = prng.key(0) if key is None else key
    return prng.draw([(k, i) for i in range(steps)], tuple(x.shape), "normal",
                     torch.float32, x.device)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """sampling_utils.get_ancestral_step in float32: (sigma_down,
    sigma_up)."""
    sf, st = f32(sigma_from), f32(sigma_to)
    sigma_up = np.minimum(st, f32(eta) * np.sqrt(
        st ** 2 * (sf ** 2 - st ** 2) / np.maximum(sf ** 2, f32(1e-20))))
    sigma_down = np.sqrt(np.maximum(st ** 2 - sigma_up ** 2, f32(0.0)))
    return f32(sigma_down), f32(sigma_up)


def t_of(sigma):
    return f32(-np.log(np.maximum(f32(sigma), f32(1e-20))))


def sigma_of(t):
    return f32(np.exp(-f32(t)))


def edm_sample(denoise_fn: Callable, noise: torch.Tensor, sigmas,
               key: prng.Key | None = None, s_churn: float = 0.0,
               s_tmin: float = 0.0, s_tmax: float = float("inf"),
               s_noise: float = 1.0, heun: bool = False,
               eps: torch.Tensor | None = None) -> torch.Tensor:
    """EDM sampler with churn (step i's normals from fold_in(key, i) when
    s_churn > 0, or `eps`) and the optional 2nd-order Heun correction,
    skipped at the last sigma."""
    sig = _host(sigmas)
    n = sig.shape[0]
    gamma_val = min(s_churn / (n - 1), 2 ** 0.5 - 1) if s_churn > 0 else 0.0
    x = init_noise_scaling(noise.float(), sig[0])
    if gamma_val > 0:
        eps = _step_normals(key, n - 1, x, eps)
    for i in range(n - 1):
        sigma, nxt = sig[i], sig[i + 1]
        gamma = f32(gamma_val) if s_tmin <= sigma <= s_tmax else f32(0.0)
        sigma_hat = f32(sigma * f32(gamma + f32(1.0)))
        if gamma_val > 0:
            churn = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2, f32(0.0)))
            x = x + (eps[i].float() * s_noise) * float(churn)
        d = to_d(x, float(sigma_hat), _call(denoise_fn, x, sigma_hat))
        dt = float(f32(nxt - sigma_hat))
        x_euler = x + d * dt
        if heun and nxt > 0:
            d2 = to_d(x_euler, float(nxt), _call(denoise_fn, x_euler, nxt))
            x = x + 0.5 * (d + d2) * dt
        else:
            x = x_euler
    return x


def euler_ancestral_sample(denoise_fn, noise, sigmas,
                           key: prng.Key | None = None, eta: float = 1.0,
                           s_noise: float = 1.0,
                           eps: torch.Tensor | None = None) -> torch.Tensor:
    """EulerAncestralSampler; step i's normals (fold_in(key, i), or eps[i])
    added where the next sigma is above 0."""
    sig = _host(sigmas)
    x = init_noise_scaling(noise.float(), sig[0])
    eps = _step_normals(key, sig.shape[0] - 1, x, eps)
    for i in range(sig.shape[0] - 1):
        sigma, nxt = sig[i], sig[i + 1]
        down, up = get_ancestral_step(sigma, nxt, eta)
        d = to_d(x, float(sigma), _call(denoise_fn, x, sigma))
        x = x + d * float(f32(down - sigma))
        if nxt > 0:
            x = x + eps[i].float() * s_noise * float(up)
    return x


def dpmpp2s_ancestral_sample(denoise_fn, noise, sigmas,
                             key: prng.Key | None = None, eta: float = 1.0,
                             s_noise: float = 1.0,
                             eps: torch.Tensor | None = None) -> torch.Tensor:
    """DPMPP2SAncestralSampler: the DPM-Solver++(2S) step to sigma_down
    (two denoiser calls) where sigma_down > 1e-14, else an Euler step;
    then the ancestral noise (step i's normals from fold_in(key, i), or
    eps[i]) where the next sigma is above 0."""
    sig = _host(sigmas)
    x = init_noise_scaling(noise.float(), sig[0])
    eps = _step_normals(key, sig.shape[0] - 1, x, eps)
    for i in range(sig.shape[0] - 1):
        sigma, nxt = sig[i], sig[i + 1]
        down, up = get_ancestral_step(sigma, nxt, eta)
        denoised = _call(denoise_fn, x, sigma)
        if down > 1e-14:
            t, t_next = t_of(sigma), t_of(down)
            h = f32(t_next - t)
            s = f32(t + f32(0.5) * h)
            x2 = (float(f32(sigma_of(s) / sigma_of(t))) * x
                  - float(np.expm1(f32(-h * f32(0.5)))) * denoised)
            denoised2 = _call(denoise_fn, x2, sigma_of(s))
            x_new = (float(f32(sigma_of(t_next) / sigma_of(t))) * x
                     - float(np.expm1(-h)) * denoised2)
        else:
            x_new = x + to_d(x, float(sigma), denoised) * float(f32(down - sigma))
        if nxt > 0:
            x_new = x_new + eps[i].float() * s_noise * float(up)
        x = x_new
    return x


def _dpmpp2m_coeffs(sig: np.ndarray, i: int, eta: float = 0.0):
    """Step i's DPM++(2M) scalars: (mult1, mult2, c_new, c_old, h) with
    x_next = mult1 x - mult2 (c_new denoised - c_old old_denoised); c_new
    1 and c_old None on the first-order steps (the first, and a step to a
    sigma of 1e-14 or less)."""
    sigma, nxt = sig[i], sig[i + 1]
    t, t_next = t_of(sigma), t_of(nxt)
    h = f32(t_next - t)
    eta_h = f32(f32(eta) * h)
    mult1 = f32(f32(sigma_of(t_next) / sigma_of(t)) * np.exp(-eta_h))
    mult2 = f32(np.expm1(f32(-h - eta_h)))
    if i > 0 and nxt > 1e-14:
        r = f32(f32(t - t_of(sig[i - 1])) / h)
        c_old = f32(f32(1.0) / f32(f32(2.0) * r))
        return mult1, mult2, f32(f32(1.0) + c_old), c_old, h
    return mult1, mult2, f32(1.0), None, h


def _dpm_update(mult1, mult2, x, den, c_new, c_old, old):
    """mult1 x - mult2 (c_new den - c_old old); first order without old."""
    if c_old is None:
        return float(mult1) * x - float(mult2) * den
    return (float(mult1) * x
            - float(mult2) * (float(c_new) * den - float(c_old) * old))


def _increment(w_next, w_cur, sigma, nxt) -> torch.Tensor:
    """The Brownian path's increment over [sigma, nxt], unit variance."""
    dsig = np.maximum(np.abs(f32(nxt - sigma)), f32(1e-20))
    return (w_next - w_cur) / float(np.sqrt(dsig))


def _injection(eps, nxt, eta: float, h, s_noise: float) -> torch.Tensor:
    """eps * nxt * sqrt(-expm1(-2 eta h)) * s_noise: RestoreDPMPP2M's noise."""
    scale = np.sqrt(-np.expm1(f32(f32(-2.0) * f32(f32(eta) * h))))
    return eps * float(nxt) * float(scale) * s_noise


def dpmpp2m_sample(denoise_fn, noise, sigmas) -> torch.Tensor:
    """DPMPP2MSampler: the 2nd-order multistep DPM-Solver++ update."""
    sig = _host(sigmas)
    x = init_noise_scaling(noise.float(), sig[0])
    old = None
    for i in range(sig.shape[0] - 1):
        denoised = _call(denoise_fn, x, sig[i])
        mult1, mult2, c_new, c_old, _ = _dpmpp2m_coeffs(sig, i)
        x = _dpm_update(mult1, mult2, x, denoised, c_new, c_old, old)
        old = denoised
    return x


def lms_coeffs(sigmas, order: int = 4) -> np.ndarray:
    """[steps, order] Adams-Bashforth coefficients: the integral of each
    Lagrange basis over [sigma_i, sigma_{i+1}], by the trapezoid rule on 257
    points, in float64 on the host."""
    sig = np.asarray(_host(sigmas), np.float64)
    n = len(sig) - 1

    def lms_coeff(o, i, j):
        def fn(tau):
            prod = 1.0
            for k in range(o):
                if k == j:
                    continue
                prod *= (tau - sig[i - k]) / (sig[i - j] - sig[i - k])
            return prod
        xs = np.linspace(sig[i], sig[i + 1], 257)
        ys = np.asarray([fn(t) for t in xs])
        return float((np.diff(xs) * (ys[1:] + ys[:-1]) / 2.0).sum())

    coeffs = np.zeros((n, order))
    for i in range(n):
        for j in range(min(i + 1, order)):
            coeffs[i, j] = lms_coeff(min(i + 1, order), i, j)
    return coeffs.astype(np.float32)


def linear_multistep_sample(denoise_fn, noise, sigmas,
                            order: int = 4) -> torch.Tensor:
    """LinearMultistepSampler: x += sum_j coeff[i, j] d_{i-j} over the last
    `order` directions."""
    sig = _host(sigmas)
    coeffs = lms_coeffs(sig, order)
    x = init_noise_scaling(noise.float(), sig[0])
    hist: list = []
    for i in range(sig.shape[0] - 1):
        d = to_d(x, float(sig[i]), _call(denoise_fn, x, sig[i]))
        hist = [d] + hist[:order - 1]
        step = sum(float(c) * h for c, h in zip(coeffs[i], hist))
        x = x + step
    return x


def substep_sigmas(n_sample_steps: int = 4,
                   num_timesteps: int = 1000) -> torch.Tensor:
    """SubstepSampler's sigma subset: indices [0, 100, 200, 300][:n] + [1000]
    into the descending 1001-entry LegacyDDPM table (the high-sigma end and
    the terminal 0)."""
    full = legacy_ddpm_sigmas(num_timesteps)
    subset = [0, 100, 200, 300, 1000]
    idx = subset[:n_sample_steps] + subset[-1:]
    return full[idx].clone()


def restore_dpmpp2m_sample(denoise_fn, noise, sigmas,
                           key: prng.Key | None = None,
                           eta: float = 1.0, s_noise: float = 1.0,
                           eps_override: torch.Tensor | None = None):
    """RestoreDPMPP2MSampler: the stochastic DPM++(2M) on a Karras ramp
    re-derived over [sigmas[-2], sigmas[0]]; on every non-first step to a
    sigma above 1e-14 it injects next_sigma * sqrt(-expm1(-2 eta h)) *
    s_noise times the normalized Brownian increment over the step, the
    tree's path that of `key` (default PRNGKey(0)) on x's device;
    eps_override [steps, *x.shape] injects those normals instead."""
    sig = _host(sigmas)
    n = len(sig) - 1
    sig = _host(karras_sigmas(n, float(sig[-2]), float(sig[0])))
    x = init_noise_scaling(noise.float(), sig[0])
    tree = BrownianTreeNoiseSampler(float(sig[-2]), float(sig[0]), x.shape,
                                    key, x.device)
    brownian = eta > 0 and eps_override is None
    w_cur = tree.w(sig[0]) if brownian else None
    old = None
    for i in range(n):
        sigma, nxt = sig[i], sig[i + 1]
        denoised = _call(denoise_fn, x, sigma)
        mult1, mult2, c_new, c_old, h = _dpmpp2m_coeffs(sig, i, eta)
        x_new = _dpm_update(mult1, mult2, x, denoised, c_new, c_old, old)
        w_next = tree.w(nxt) if brownian else None
        if eta > 0 and c_old is not None:
            eps = (eps_override[i].float() if eps_override is not None
                   else _increment(w_next, w_cur, sigma, nxt))
            x_new = x_new + _injection(eps, nxt, eta, h, s_noise)
        x, old, w_cur = x_new, denoised, w_next
    return x


# --------------------------------------------------------------- tiled loop

def gaussian_tile_weights(tile_h: int, tile_w: int) -> torch.Tensor:
    """Gaussian contribution mask [tile_h, tile_w] of a sliding latent tile;
    x is centred at (tile_w - 1) / 2 and y at tile_h / 2, as the
    reference's mask is."""
    var = 0.01
    midx = (tile_w - 1) / 2
    xs = np.exp(-(np.arange(tile_w) - midx) ** 2 / (tile_w * tile_w) / (2 * var)) \
        / math.sqrt(2 * math.pi * var)
    midy = tile_h / 2
    ys = np.exp(-(np.arange(tile_h) - midy) ** 2 / (tile_h * tile_h) / (2 * var)) \
        / math.sqrt(2 * math.pi * var)
    return torch.as_tensor(np.outer(ys, xs).astype(np.float32))


def sliding_windows(h: int, w: int, tile: int, stride: int):
    """[(h0, h1, w0, w1)] of tile x tile windows at `stride`, the last one
    in each axis flush with the edge."""
    hs = list(range(0, h - tile + 1, stride))
    if (h - tile) % stride != 0 and h > tile:
        hs.append(h - tile)
    ws = list(range(0, w - tile + 1, stride))
    if (w - tile) % stride != 0 and w > tile:
        ws.append(w - tile)
    if not hs:
        hs = [0]
    if not ws:
        ws = [0]
    return [(i, i + tile, j, j + tile) for i in hs for j in ws]


def tile_slices(canvas: torch.Tensor, wins) -> torch.Tensor:
    """Every window of an NHWC canvas stacked on the batch axis."""
    return torch.cat([canvas[:, hi:he, wi:we, :] for hi, he, wi, we in wins],
                     dim=0)


def tile_stitch(tiles, wins, weights, out_shape, out_dtype) -> torch.Tensor:
    """The weighted tiles added back onto a zero canvas of `out_shape`, in
    window order (out_shape[0] tiles per window)."""
    b = out_shape[0]
    acc = torch.zeros(out_shape, dtype=out_dtype, device=tiles.device)
    for t_idx, (hi, he, wi, we) in enumerate(wins):
        acc[:, hi:he, wi:we, :] += tiles[t_idx * b:(t_idx + 1) * b] * weights
    return acc


def tile_weight_canvas(wins, weights, out_shape, out_dtype) -> torch.Tensor:
    """The sum of the windows' weights over the canvas, built once a
    sample."""
    acc = torch.zeros(out_shape, dtype=out_dtype, device=weights.device)
    for hi, he, wi, we in wins:
        acc[:, hi:he, wi:we, :] += weights
    return acc


def _tile_weights(tile: int, device) -> torch.Tensor:
    return gaussian_tile_weights(tile, tile).to(device)[None, :, :, None]


def tiled_restore_edm_sample(denoise_tile_fn, noise, sigmas, x_center,
                             lq_latent, key: prng.Key | None = None,
                             tile: int = 128, stride: int = 64,
                             restore_cfg: float = -1.0,
                             restore_cfg_s_tmin: float = 0.05,
                             s_noise: float = 1.003, s_churn: float = 0.0,
                             sigma_max: float = 14.6146,
                             eps: torch.Tensor | None = None) -> torch.Tensor:
    """TiledRestoreEDMSampler: each step denoises the gaussian-weighted
    sliding tiles in one call (each tile's control is the matching
    lq_latent crop), drifts them to x_center's tiles where restore_cfg > 0
    and the next sigma is above restore_cfg_s_tmin, takes the Euler step
    per tile and stitches. With s_churn > 0 step i's normals come from
    fold_in(key, i) (default PRNGKey(0)) over the canvas, or from eps."""
    sig = _host(sigmas)
    n = sig.shape[0]
    wins = sliding_windows(noise.shape[1], noise.shape[2], tile, stride)
    weights = _tile_weights(tile, noise.device)
    x = init_noise_scaling(noise.float(), sig[0])
    gamma_val = min(s_churn / (n - 1), 2 ** 0.5 - 1) if s_churn > 0 else 0.0
    if gamma_val > 0:
        eps = _step_normals(key, n - 1, x, eps)
    lq_tiles = tile_slices(lq_latent, wins)
    xc_tiles = tile_slices(x_center.float(), wins)
    cnt = tile_weight_canvas(wins, weights, x.shape, x.dtype)
    for i in range(n - 1):
        sigma, nxt = sig[i], sig[i + 1]
        sigma_hat = f32(sigma * f32(f32(1.0) + f32(gamma_val)))
        if gamma_val > 0:
            churn = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2, f32(0.0)))
            x = x + (eps[i].float() * s_noise) * float(churn)
        tiles = tile_slices(x, wins)
        den = _call(denoise_tile_fn, tiles, sigma_hat, lq_tiles)
        if restore_cfg > 0 and nxt > restore_cfg_s_tmin:
            wgt = f32(f32(sigma / f32(sigma_max)) ** f32(restore_cfg))
            den = den - (den - xc_tiles) * float(wgt)
        d = (tiles - den) / float(sigma_hat)
        stepped = tiles + d * float(f32(nxt - sigma_hat))
        x = tile_stitch(stepped, wins, weights, x.shape, x.dtype) / cnt
    return x


def tiled_restore_dpmpp2m_sample(denoise_tile_fn, noise, sigmas, lq_latent,
                                 key: prng.Key | None = None,
                                 tile: int = 128, stride: int = 64,
                                 eta: float = 1.0,
                                 s_noise: float = 1.0) -> torch.Tensor:
    """TiledRestoreDPMPP2MSampler: the stochastic DPM++(2M) update per
    gaussian-weighted sliding tile, one denoiser call a step; the stepped
    tiles and the step's denoised tiles are both stitched back to canvases,
    and the next step re-slices the stitched old_denoised. The Brownian
    increment is drawn on the whole canvas and sliced per tile (key: as
    `restore_dpmpp2m_sample`'s)."""
    sig = _host(sigmas)
    n = len(sig) - 1
    sig = _host(karras_sigmas(n, float(sig[-2]), float(sig[0])))
    shape = tuple(noise.shape)
    wins = sliding_windows(shape[1], shape[2], tile, stride)
    weights = _tile_weights(tile, noise.device)
    x = init_noise_scaling(noise.float(), sig[0])
    tree = BrownianTreeNoiseSampler(float(sig[-2]), float(sig[0]), shape,
                                    key, x.device)
    lq_tiles = tile_slices(lq_latent, wins)
    cnt = tile_weight_canvas(wins, weights, shape, torch.float32)
    stitch = lambda t: tile_stitch(t, wins, weights, shape, t.dtype) / cnt
    w_cur = tree.w(sig[0]) if eta > 0 else None
    old = None
    for i in range(n):
        sigma, nxt = sig[i], sig[i + 1]
        tiles = tile_slices(x, wins)
        den = _call(denoise_tile_fn, tiles, sigma, lq_tiles)
        mult1, mult2, c_new, c_old, h = _dpmpp2m_coeffs(sig, i, eta)
        old_tiles = tile_slices(old, wins) if c_old is not None else None
        stepped = _dpm_update(mult1, mult2, tiles, den, c_new, c_old, old_tiles)
        w_next = tree.w(nxt) if eta > 0 else None
        if eta > 0 and c_old is not None:
            eps = tile_slices(_increment(w_next, w_cur, sigma, nxt), wins)
            stepped = stepped + _injection(eps, nxt, eta, h, s_noise)
        x, old, w_cur = stitch(stepped), stitch(den), w_next
    return x
