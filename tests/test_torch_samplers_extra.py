"""The port's sgm sampler family (rsvldm_tpu_torch/diffusion/samplers_extra.py)
held against the JAX package's, fp32 on the CPU: every sampler and tile
helper with one analytic denoiser written in both frameworks and the same
key on both sides, nothing injected (the port draws JAX's eps of
fold_in(rng, i) and JAX's Brownian tree from the key itself), latents
within 1e-5; and the tiled samplers over the small-width ControlDenoiser
with CFG, loaded from a seeded Flax tree (2 x 2 tiles, 3 steps, 1e-4
relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.diffusion import samplers_extra as J
from rsvldm_tpu.diffusion.guidance import apply_cfg as j_apply_cfg
from rsvldm_tpu.diffusion.schedules import karras_sigmas as j_karras
from rsvldm_tpu.diffusion.schedules import legacy_ddpm_sigmas as j_legacy
from rsvldm_tpu.models.sdxl.control import ControlledUNet as JCUNet
from rsvldm_tpu.models.sdxl.control import GLVControl as JControl
from rsvldm_tpu.models.sdxl.denoiser import ControlDenoiser as JDenoiser
from rsvldm_tpu_torch.diffusion import samplers_extra as S
from rsvldm_tpu_torch.diffusion.guidance import apply_cfg
from rsvldm_tpu_torch.diffusion.schedules import (karras_sigmas,
                                                  legacy_ddpm_sigmas)
from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
from rsvldm_tpu_torch.utils import prng
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, assert_close, randomize,
                              to_np)

torch.set_num_threads(1)
SHAPE = (1, 8, 8, 2)
RNG = np.random.default_rng(0)
NOISE = RNG.standard_normal(SHAPE).astype(np.float32)
TARGET = (0.37 + 0.1 * RNG.standard_normal(SHAPE)).astype(np.float32)
LQ = RNG.standard_normal((1, 12, 12, 2)).astype(np.float32)
KEY = jax.random.PRNGKey(3)
PKEY = prng.key(3)


def j_gauss(x, sigma):
    return (x + sigma ** 2 * jnp.asarray(TARGET)) / (1 + sigma ** 2)


def t_gauss(x, sigma):
    return (x + sigma ** 2 * torch.from_numpy(TARGET)) / (1 + sigma ** 2)


def fold_eps(key, steps, shape):
    """The normals JAX's samplers draw in step i, normal(fold_in(key, i)),
    computed by JAX (for the eps / eps_override arguments)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)) for i in range(steps)]))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# name: (JAX call, port call); sigmas 6 LegacyDDPM steps unless named
CASES = {
    "edm": (lambda s: J.edm_sample(j_gauss, NOISE, s, KEY),
            lambda s: S.edm_sample(t_gauss, _t(NOISE), s)),
    "edm_churn": (lambda s: J.edm_sample(j_gauss, NOISE, s, KEY, s_churn=2.0,
                                         s_noise=1.003),
                  lambda s: S.edm_sample(t_gauss, _t(NOISE), s, PKEY,
                                         s_churn=2.0, s_noise=1.003)),
    "heun": (lambda s: J.edm_sample(j_gauss, NOISE, s, KEY, heun=True),
             lambda s: S.edm_sample(t_gauss, _t(NOISE), s, heun=True)),
    "euler_ancestral": (
        lambda s: J.euler_ancestral_sample(j_gauss, NOISE, s, KEY),
        lambda s: S.euler_ancestral_sample(t_gauss, _t(NOISE), s, PKEY)),
    "dpmpp2s_ancestral": (
        lambda s: J.dpmpp2s_ancestral_sample(j_gauss, NOISE, s, KEY, eta=0.7),
        lambda s: S.dpmpp2s_ancestral_sample(t_gauss, _t(NOISE), s, PKEY,
                                             eta=0.7)),
    "dpmpp2m": (lambda s: J.dpmpp2m_sample(j_gauss, NOISE, s),
                lambda s: S.dpmpp2m_sample(t_gauss, _t(NOISE), s)),
    "lms": (lambda s: J.linear_multistep_sample(j_gauss, NOISE, s),
            lambda s: S.linear_multistep_sample(t_gauss, _t(NOISE), s)),
    "substep": (lambda s: J.edm_sample(j_gauss, NOISE, J.substep_sigmas(4), KEY),
                lambda s: S.edm_sample(t_gauss, _t(NOISE), S.substep_sigmas(4))),
    "restore_dpmpp2m": (
        lambda s: J.restore_dpmpp2m_sample(j_gauss, NOISE, s, KEY),
        lambda s: S.restore_dpmpp2m_sample(t_gauss, _t(NOISE), s, PKEY)),
    "restore_dpmpp2m_eta0": (
        lambda s: J.restore_dpmpp2m_sample(j_gauss, NOISE, s, KEY, eta=0.0),
        lambda s: S.restore_dpmpp2m_sample(t_gauss, _t(NOISE), s, eta=0.0)),
    "restore_dpmpp2m_override": (
        lambda s: J.restore_dpmpp2m_sample(
            j_gauss, NOISE, s, KEY, s_noise=0.9,
            eps_override=jnp.asarray(fold_eps(KEY, len(s) - 1, SHAPE).numpy())),
        lambda s: S.restore_dpmpp2m_sample(
            t_gauss, _t(NOISE), s, s_noise=0.9,
            eps_override=fold_eps(KEY, len(s) - 1, SHAPE))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sampler_equals_jax(name):
    j_fn, t_fn = CASES[name]
    want = np.asarray(j_fn(j_legacy(6)))
    got = t_fn(legacy_ddpm_sigmas(6)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_lms_on_karras_equals_jax():
    want = np.asarray(J.linear_multistep_sample(j_gauss, NOISE,
                                                j_karras(9, 0.05, 20.0)))
    got = S.linear_multistep_sample(t_gauss, _t(NOISE), karras_sigmas(9, 0.05, 20.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_scalar_helpers_equal_jax():
    sig = np.asarray(j_legacy(10))
    for a, b in zip(sig[:-1], sig[1:]):
        for eta in (1.0, 0.5):
            jd, ju = J.get_ancestral_step(a, b, eta)
            td, tu = S.get_ancestral_step(a, b, eta)
            np.testing.assert_allclose([td, tu], [float(jd), float(ju)],
                                       rtol=1e-6, atol=1e-7)
        assert np.isclose(S.t_of(a), float(J.t_of(a)), rtol=1e-6)
        assert np.isclose(S.sigma_of(S.t_of(a)), float(J.sigma_of(J.t_of(a))),
                          rtol=1e-6)
    np.testing.assert_array_equal(karras_sigmas(7, 0.03, 14.6).numpy(),
                                  np.asarray(j_karras(7, 0.03, 14.6)))
    np.testing.assert_array_equal(S.substep_sigmas(3).numpy(),
                                  np.asarray(J.substep_sigmas(3)))


@pytest.mark.parametrize("h,w,tile,stride", [(16, 24, 8, 8), (20, 8, 8, 8),
                                             (12, 12, 8, 4), (7, 9, 8, 4),
                                             (192, 192, 128, 64)])
def test_tile_helpers_equal_jax(h, w, tile, stride):
    wins = S.sliding_windows(h, w, tile, stride)
    assert wins == J.sliding_windows(h, w, tile, stride)
    wt = S.gaussian_tile_weights(tile, tile + 3)
    np.testing.assert_array_equal(wt.numpy(),
                                  np.asarray(J.gaussian_tile_weights(tile, tile + 3)))
    if max(h, w) > 32:
        return
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    t = min(tile, h), min(tile, w)
    wins = [(a, a + t[0], b, b + t[1]) for a, _, b, _ in wins]
    weights = np.asarray(J.gaussian_tile_weights(*t))[None, :, :, None]
    jt = J.tile_slices(jnp.asarray(x), wins)
    tt = S.tile_slices(_t(x), wins)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(
        S.tile_stitch(tt, wins, _t(weights), x.shape, torch.float32).numpy(),
        np.asarray(J.tile_stitch(jt, wins, jnp.asarray(weights), x.shape,
                                 jnp.float32)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        S.tile_weight_canvas(wins, _t(weights), x.shape, torch.float32).numpy(),
        np.asarray(J.tile_weight_canvas(wins, jnp.asarray(weights), x.shape,
                                        jnp.float32)), rtol=1e-6, atol=1e-6)


def j_tile(tiles, sigma, lq):
    return (tiles + sigma ** 2 * (0.37 + 0.1 * lq)) / (1 + sigma ** 2)


def t_tile(tiles, sigma, lq):
    return (tiles + sigma ** 2 * (0.37 + 0.1 * lq)) / (1 + sigma ** 2)


TILED = {
    "edm_restore_cfg": dict(restore_cfg=4.0),
    "edm_churn": dict(s_churn=3.0),
    "dpmpp2m": dict(eta=1.0),
    "dpmpp2m_eta0": dict(eta=0.0),
}


@pytest.mark.parametrize("name", list(TILED))
def test_tiled_equals_jax(name):
    kw = TILED[name]
    noise = np.random.default_rng(5).standard_normal(LQ.shape).astype(np.float32)
    xc = np.random.default_rng(6).standard_normal(LQ.shape).astype(np.float32)
    js, ts = j_legacy(6), legacy_ddpm_sigmas(6)
    if name.startswith("edm"):
        want = J.tiled_restore_edm_sample(j_tile, noise, js, xc, LQ, KEY,
                                          tile=8, stride=4, **kw)
        got = S.tiled_restore_edm_sample(t_tile, _t(noise), ts, _t(xc), _t(LQ),
                                         PKEY, tile=8, stride=4, **kw)
    else:
        want = J.tiled_restore_dpmpp2m_sample(j_tile, noise, js, LQ, KEY,
                                              tile=8, stride=4, **kw)
        got = S.tiled_restore_dpmpp2m_sample(t_tile, _t(noise), ts, _t(LQ),
                                             PKEY, tile=8, stride=4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_single_window_tiled_dpmpp2m_equals_untiled():
    """One window over the whole canvas: the weights normalize out and the
    increment slice is the canvas, so the tiled sampler is the untiled one
    (the card's `samplers` phase holds the same at full width)."""
    key = prng.key(5)
    a = S.restore_dpmpp2m_sample(t_gauss, _t(NOISE), legacy_ddpm_sigmas(8), key)
    b = S.tiled_restore_dpmpp2m_sample(lambda t, s, _lq: t_gauss(t, s), _t(NOISE),
                                       legacy_ddpm_sigmas(8), _t(NOISE), key,
                                       tile=8, stride=8)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_eps_is_required_where_noise_is_drawn():
    """Where a sampler draws noise and no eps is given, it draws JAX's from
    the default key, PRNGKey(0) (JAX's samplers given PRNGKey(0)); an eps
    given is used instead (JAX's normals of fold_in(key, i) passed in give
    JAX's latents)."""
    j0, s4 = jax.random.PRNGKey(0), legacy_ddpm_sigmas(4)
    want = np.asarray(J.edm_sample(j_gauss, NOISE, j_legacy(4), j0, s_churn=1.0))
    got = S.edm_sample(t_gauss, _t(NOISE), s4, s_churn=1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got = S.edm_sample(t_gauss, _t(NOISE), s4, prng.key(9), s_churn=1.0,
                       eps=fold_eps(j0, len(s4) - 1, SHAPE))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(J.tiled_restore_edm_sample(
        j_tile, LQ, j_legacy(4), LQ, LQ, j0, tile=8, stride=4, s_churn=1.0))
    got = S.tiled_restore_edm_sample(t_tile, _t(LQ), s4, _t(LQ), _t(LQ),
                                     tile=8, stride=4, s_churn=1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------ the controlled SDXL denoiser

@pytest.fixture(scope="module")
def denoisers():
    cfg = JAX_TINY["sdxl"]
    lat = jnp.zeros((1, 8, 8, 4))
    t = jnp.zeros((1,))
    ctx = jnp.zeros((1, 7, cfg.context_dim))
    y = jnp.zeros((1, cfg.adm_in_channels))
    jctrl, junet = JControl(cfg), JCUNet(cfg)
    key = jax.random.PRNGKey(0)
    ctree = to_np(randomize(jax.eval_shape(jctrl.init, key, lat, lat, t, ctx, y), 31))
    feats = jax.eval_shape(jctrl.apply, ctree, lat, lat, t, ctx, y)
    utree = to_np(randomize(jax.eval_shape(junet.init, key, lat, t, ctx, y, feats), 32))
    jd = JDenoiser(unet=junet, control_net=jctrl, unet_params=utree,
                   control_params=ctree)

    def port(cls, family, tree):
        m = cls(TORCH_TINY["sdxl"])
        m.load_state_dict(params_from_jax(family, tree, TORCH_TINY["sdxl"]),
                          strict=True)
        return m.eval().requires_grad_(False)

    td = ControlDenoiser(unet=port(ControlledUNet, "unet", utree),
                         control_net=port(GLVControl, "control", ctree))
    rng = np.random.default_rng(9)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    cond = [dict(crossattn=mk(1, 7, cfg.context_dim),
                 vector=mk(1, cfg.adm_in_channels)) for _ in range(2)]
    return jd, td, cond


def _cfg_tile_fns(jd, td, cond, scale=5.0):
    """denoise_tile_fn of both frameworks: CFG batch 2 x tiles, uncond
    first, each tile's control its LQ crop."""
    uc, c = cond

    def both(v, t):
        return np.concatenate([np.repeat(uc[v], t, 0), np.repeat(c[v], t, 0)])

    def j_fn(tiles, sigma, lq):
        t = tiles.shape[0]
        cd = dict(crossattn=jnp.asarray(both("crossattn", t)),
                  vector=jnp.asarray(both("vector", t)),
                  control=jnp.concatenate([lq, lq]))
        out = jd(jnp.concatenate([tiles, tiles]), jnp.full((2 * t,), sigma), cd)
        return j_apply_cfg(out, scale)

    def t_fn(tiles, sigma, lq):
        t = tiles.shape[0]
        nchw = lambda v: v.permute(0, 3, 1, 2)
        cd = dict(crossattn=_t(both("crossattn", t)),
                  vector=_t(both("vector", t)),
                  control=nchw(torch.cat([lq, lq])))
        out = td(nchw(torch.cat([tiles, tiles])), sigma.expand(2 * t), cd)
        return apply_cfg(out.permute(0, 2, 3, 1), scale)

    return j_fn, t_fn


@pytest.mark.parametrize("sampler", ["edm", "dpmpp2m"])
def test_tiled_control_denoiser_equals_jax(denoisers, sampler):
    jd, td, cond = denoisers
    j_fn, t_fn = _cfg_tile_fns(jd, td, cond)
    rng = np.random.default_rng(11)
    shape = (1, 12, 12, 4)
    noise, xc, lq = (rng.standard_normal(shape).astype(np.float32)
                     for _ in range(3))
    js, ts = j_legacy(3), legacy_ddpm_sigmas(3)
    with torch.no_grad():
        if sampler == "edm":
            want = J.tiled_restore_edm_sample(j_fn, noise, js, xc, lq, KEY,
                                              tile=8, stride=4, restore_cfg=4.0)
            got = S.tiled_restore_edm_sample(t_fn, _t(noise), ts, _t(xc), _t(lq),
                                             tile=8, stride=4, restore_cfg=4.0)
        else:
            want = J.tiled_restore_dpmpp2m_sample(j_fn, noise, js, lq, KEY,
                                                  tile=8, stride=4)
            got = S.tiled_restore_dpmpp2m_sample(t_fn, _t(noise), ts, _t(lq),
                                                 PKEY, tile=8, stride=4)
    assert len(S.sliding_windows(12, 12, 8, 4)) == 4
    assert_close(got.numpy(), np.asarray(want), tol=1e-4)
