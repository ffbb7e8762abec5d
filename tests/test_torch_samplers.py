"""The port's samplers held against the JAX package's at tiny geometry, fp32
on the CPU, with the same weights and the same noise: the SR3 ancestral loop
(injected noise, and the noise rebuilt from the JAX key chain), SR3 DDIM
(eta 0 and 0.5, JAX's key chain injected) and
RestoreEDM with the first-block cache on and off. Latents within 1e-4;
cache decisions identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.diffusion.samplers import RestoreEDMConfig as JEDMConfig
from rsvldm_tpu.diffusion.samplers import restore_edm_sample as j_restore
from rsvldm_tpu.models.sdxl.control import ControlledUNet as JCUNet
from rsvldm_tpu.models.sdxl.control import GLVControl as JControl
from rsvldm_tpu.models.sdxl.denoiser import ControlDenoiser as JDenoiser
from rsvldm_tpu.models.sr3.diffusion import SR3Diffusion as JSR3Diffusion
from rsvldm_tpu.models.sr3.diffusion import sr3_sample as j_sr3_sample
from rsvldm_tpu.models.sr3.diffusion import sr3_sample_ddim as j_sr3_ddim
from rsvldm_tpu.models.sr3.unet import SR3UNet as JSR3UNet
from rsvldm_tpu_torch.diffusion.samplers import RestoreEDMConfig
from rsvldm_tpu_torch.diffusion.samplers import restore_edm_sample
from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
from rsvldm_tpu_torch.models.sr3.diffusion import (SR3Diffusion, ddim_timesteps,
                                                   sr3_sample, sr3_sample_ddim)
from rsvldm_tpu_torch.models.sr3.unet import SR3UNet
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, assert_close, randomize,
                              sr3_noise_from_key, to_np)

torch.set_num_threads(1)
T_SR3, LAT, N = 6, 8, 1


def _port(cls, family, tree, cfg):
    m = cls(cfg)
    m.load_state_dict(params_from_jax(family, tree, cfg), strict=True)
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def sr3():
    jm = JSR3UNet(JAX_TINY["sr3"])
    tree = to_np(randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)),
        jnp.ones((1, 1))), 11))
    return jm, tree, _port(SR3UNet, "sr3", tree, TORCH_TINY["sr3"])


@pytest.mark.parametrize("noise_from", ["override", "key_chain"])
def test_sr3_sample(sr3, noise_from):
    jm, tree, tm = sr3
    rng = np.random.default_rng(4)
    cond = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jdiff = JSR3Diffusion.from_schedule("linear", T_SR3, 1e-6, 1e-2)
    apply_fn = lambda p, x, nl: jm.apply(p, x, nl)
    if noise_from == "override":
        noise = rng.standard_normal((T_SR3 + 1, *cond.shape)).astype(np.float32)
        want = j_sr3_sample(jdiff, apply_fn, tree, jnp.asarray(cond), key,
                            noise_override=jnp.asarray(noise))
    else:
        noise = sr3_noise_from_key(key, T_SR3, cond.shape)
        want = j_sr3_sample(jdiff, apply_fn, tree, jnp.asarray(cond), key)
    tdiff = SR3Diffusion.from_schedule("linear", T_SR3, 1e-6, 1e-2)
    got = sr3_sample(tdiff, tm, torch.from_numpy(cond), torch.from_numpy(noise))
    assert_close(got.numpy(), want)


def ddim_noise_from_key(key, ts, shape):
    """The unit normals JAX sr3_sample_ddim draws from `key`: [0] = x_T
    from split(key)[1], [1+j] = normal(fold_in(split(key)[0], ts[j]))."""
    rng, init_rng = jax.random.split(key)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(rng, int(t)), shape,
                                jnp.float32) for t in ts]
    return np.stack([np.asarray(d) for d in draws])


@pytest.mark.parametrize("steps,eta", [(4, 0.0), (4, 0.5), (T_SR3, 0.5),
                                       (50, 0.0)])
def test_sr3_sample_ddim(sr3, steps, eta):
    """JAX's timestep subset (50 steps on a 6-step schedule dedupe to 6),
    clipped x_0, recomputed eps and the eta noise, fed JAX's key chain."""
    jm, tree, tm = sr3
    rng = np.random.default_rng(6)
    cond = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jdiff = JSR3Diffusion.from_schedule("linear", T_SR3, 1e-6, 1e-2)
    want = j_sr3_ddim(jdiff, lambda p, x, nl: jm.apply(p, x, nl), tree,
                      jnp.asarray(cond), key, num_steps=steps, eta=eta)
    ts = ddim_timesteps(T_SR3, steps)
    assert len(ts) == min(steps, T_SR3)
    noise = ddim_noise_from_key(key, ts, cond.shape)
    tdiff = SR3Diffusion.from_schedule("linear", T_SR3, 1e-6, 1e-2)
    got = sr3_sample_ddim(tdiff, tm, torch.from_numpy(cond),
                          torch.from_numpy(noise), num_steps=steps, eta=eta)
    assert_close(got.numpy(), want)


@pytest.fixture(scope="module")
def denoisers():
    cfg = JAX_TINY["sdxl"]
    lat = jnp.zeros((1, LAT, LAT, 4))
    t = jnp.zeros((1,))
    ctx = jnp.zeros((1, 7, cfg.context_dim))
    y = jnp.zeros((1, cfg.adm_in_channels))
    jctrl, junet = JControl(cfg), JCUNet(cfg)
    key = jax.random.PRNGKey(0)
    ctree = to_np(randomize(jax.eval_shape(jctrl.init, key, lat, lat, t, ctx, y), 21))
    feats = jax.eval_shape(jctrl.apply, ctree, lat, lat, t, ctx, y)
    utree = to_np(randomize(jax.eval_shape(junet.init, key, lat, t, ctx, y, feats), 22))
    jd = JDenoiser(unet=junet, control_net=jctrl, unet_params=utree,
                   control_params=ctree)
    td = ControlDenoiser(
        unet=_port(ControlledUNet, "unet", utree, TORCH_TINY["sdxl"]),
        control_net=_port(GLVControl, "control", ctree, TORCH_TINY["sdxl"]))
    return jd, td


CASES = {
    # threshold picked so the tiny trajectory mixes hits and misses; the
    # default knobs (no drift, fixed control scale) run in the pipeline test
    "cache_on_restore_cfg_linear_control": dict(
        num_steps=6, img_threshold=0.15, restore_cfg=4.0,
        use_linear_control_scale=True, control_scale_start=0.5),
    "cache_off": dict(num_steps=3, img_threshold=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_restore_edm_sample(denoisers, case):
    jd, td = denoisers
    kw = CASES[case]
    rng = np.random.default_rng(len(case))
    sdxl = JAX_TINY["sdxl"]
    shape = (N, LAT, LAT, 4)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    conds = [dict(crossattn=mk(N, 7, sdxl.context_dim),
                  vector=mk(N, sdxl.adm_in_channels),
                  control=mk(*shape)) for _ in range(2)]
    noise, x_center, churn = mk(*shape), mk(*shape), mk(kw["num_steps"], *shape)
    jz, jaux = j_restore(jd, *({k: jnp.asarray(v) for k, v in c.items()} for c in conds),
                         jnp.asarray(noise), jnp.asarray(x_center), JEDMConfig(**kw),
                         jax.random.PRNGKey(0), return_aux=True,
                         churn_noise=jnp.asarray(churn))
    tconds = [{k: torch.from_numpy(v) for k, v in c.items()} for c in conds]
    tz, taux = restore_edm_sample(td, *tconds, torch.from_numpy(noise),
                                  torch.from_numpy(x_center), RestoreEDMConfig(**kw),
                                  churn_noise=torch.from_numpy(churn), return_aux=True)
    assert_close(tz.numpy(), jz)
    np.testing.assert_array_equal(taux["hit_trace"], np.asarray(jaux["hit_trace"]))
    assert taux["cache_hits"] == int(jaux["cache_hits"])
    assert taux["num_steps"] == int(jaux["num_steps"])
    np.testing.assert_allclose(taux["thresholds"], np.asarray(jaux["thresholds"]),
                               rtol=1e-4)
    if kw["img_threshold"] > 0:
        assert 0 < taux["cache_hits"] < kw["num_steps"], taux["hit_trace"]


def test_config_fields_match_jax():
    """The port's sampler config carries every knob of the JAX one, with
    the same defaults."""
    assert ({f.name: f.default for f in dataclasses.fields(RestoreEDMConfig)}
            == {f.name: f.default for f in dataclasses.fields(JEDMConfig)})
