"""The port's small pieces held against the JAX package on the same numpy
inputs: colour fix, schedules, image I/O helpers, hash-bucket tokens,
timestep embeddings and GroupNorm. fp32 on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.native
from rsvldm_tpu.diffusion import schedules as jsched
from rsvldm_tpu.models.sdxl.unet import timestep_embedding as j_temb
from rsvldm_tpu.models.text.conditioner import concat_timestep_embedding as j_cte
from rsvldm_tpu.ops import colorfix as jcolor
from rsvldm_tpu.ops import image as jimage
from rsvldm_tpu.ops.norm import GroupNorm32 as JGroupNorm32
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu_torch.diffusion import schedules as tsched
from rsvldm_tpu_torch.models.sdxl.unet import timestep_embedding as t_temb
from rsvldm_tpu_torch.models.text.conditioner import concat_timestep_embedding as t_cte
from rsvldm_tpu_torch.ops import colorfix as tcolor
from rsvldm_tpu_torch.ops import image as timage
from rsvldm_tpu_torch.ops.norm import GroupNorm32
from rsvldm_tpu_torch.pipeline import hash_tokens

torch.set_num_threads(1)
RNG = np.random.default_rng(1)


@pytest.mark.parametrize("fix", ["wavelet_reconstruction",
                                 "adaptive_instance_normalization"])
def test_colorfix(fix):
    content = RNG.uniform(-1, 1, (1, 40, 36, 3)).astype(np.float32)
    style = RNG.uniform(-1, 1, (1, 40, 36, 3)).astype(np.float32)
    want = getattr(jcolor, fix)(jnp.asarray(content), jnp.asarray(style))
    got = getattr(tcolor, fix)(torch.from_numpy(content), torch.from_numpy(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["linear", "quad", "warmup10", "warmup50",
                                  "const", "jsd", "cosine"])
def test_beta_schedules_and_ddpm_buffers(kind):
    b_t = tsched.make_beta_schedule(kind, 40, 1e-4, 2e-2)
    b_j = jsched.make_beta_schedule(kind, 40, 1e-4, 2e-2)
    np.testing.assert_array_equal(b_t, b_j)
    bt, bj = tsched.ddpm_buffers(b_t), jsched.ddpm_buffers(b_j)
    for field in bj.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(bt, field).numpy(),
                                      np.asarray(getattr(bj, field)))


@pytest.mark.parametrize("n,kw", [(50, {}), (3, {}), (1000, dict(
    do_append_zero=False, flip=True))])
def test_legacy_sigmas_and_sigma_to_idx(n, kw):
    st, sj = tsched.legacy_ddpm_sigmas(n, **kw), jsched.legacy_ddpm_sigmas(n, **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    table = tsched.legacy_ddpm_sigmas(1000, do_append_zero=False, flip=True)
    sig = RNG.uniform(0, 15, 9).astype(np.float32)
    np.testing.assert_array_equal(
        tsched.sigma_to_idx(torch.from_numpy(sig), table).numpy(),
        np.asarray(jsched.sigma_to_idx(jnp.asarray(sig), jnp.asarray(table.numpy()))))


def test_timestep_embeddings():
    # arguments reach ~1000 rad, where one fp32 ulp is 6e-5 (1.2e-4 at
    # 1024): cos/sin of the same product agree to about that between
    # libraries
    t = np.array([0.0, 3.0, 999.0], np.float32)
    np.testing.assert_allclose(t_temb(torch.from_numpy(t), 320).numpy(),
                               np.asarray(j_temb(jnp.asarray(t), 320)), atol=2e-4)
    v = np.array([[1024.0, 1024.0], [0.0, 64.0]], np.float32)
    np.testing.assert_allclose(t_cte(torch.from_numpy(v)).numpy(),
                               np.asarray(j_cte(jnp.asarray(v))), atol=4e-4)


@pytest.mark.parametrize("c,eps", [(64, 1e-6), (48, 1e-5)])
def test_group_norm32(c, eps):
    x = RNG.standard_normal((2, 5, 7, c)).astype(np.float32) * 3 + 1
    jm = JGroupNorm32(epsilon=eps)
    params = {"params": {"scale": RNG.standard_normal(c).astype(np.float32),
                         "bias": RNG.standard_normal(c).astype(np.float32)}}
    want = jm.apply(params, jnp.asarray(x))
    tm = GroupNorm32(c, eps=eps)
    tm.load_state_dict({"weight": torch.from_numpy(params["params"]["scale"]),
                        "bias": torch.from_numpy(params["params"]["bias"])})
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_hash_tokens_match_jax_fallback():
    texts = ["", " Cinematic, High Contrast aerial photo", "x " * 90]
    fake = types.SimpleNamespace(tokenizer=None,
                                 clip_l_cfg=types.SimpleNamespace(vocab_size=1000))
    tl, tg = JPipeline._tokenize(fake, texts)
    np.testing.assert_array_equal(hash_tokens(texts, 1000), np.asarray(tl))
    np.testing.assert_array_equal(np.asarray(tl), np.asarray(tg))


def test_image_io_helpers(tmp_path):
    src = Image.fromarray((RNG.random((9, 13, 3)) * 255).astype(np.uint8))
    src.save(tmp_path / "lr.png")
    np.testing.assert_array_equal(
        timage.load_lr_conditioning(str(tmp_path / "lr.png"), 4),
        jimage.load_lr_conditioning(str(tmp_path / "lr.png"), 4))
    xt, h0t, w0t = timage.pil_to_array(src, upscale=2, min_size=64)
    xj, h0j, w0j = jimage.pil_to_array(src, upscale=2, min_size=64)
    np.testing.assert_array_equal(xt, xj)
    assert (h0t, w0t) == (h0j, w0j) == (18, 26)
    y = RNG.uniform(-1.1, 1.1, (64, 96, 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(timage.array_to_pil(y, 18, 26)),
                                  np.asarray(jimage.array_to_pil(y, 18, 26)))
    np.testing.assert_array_equal(timage.to_uint8(y), jimage.to_uint8(y))
    assert timage.round_to_multiple(95.9) == jimage.round_to_multiple(95.9) == 64


def _seeded_image(side: int, kind: str, seed: int):
    if kind == "noise":
        a = np.random.default_rng(seed).random((side, side + 3, 3)) * 255
    else:
        yy, xx = np.mgrid[0:side, 0:side + 3]
        a = np.stack([127 + 120 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0)
                      for c in range(3)], axis=-1)
    return Image.fromarray(a.astype(np.uint8))


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("side", [224, 28])
def test_pil_to_array_equals_native(side, kind):
    """Stage 2b's resize: JAX's default path (the native float bicubic)
    pixel for pixel, to 1024 on the short side. PIL's 8-bit bicubic
    differs from it on about a quarter of the pixels of uniform noise."""
    assert rsvldm_tpu.native.available()
    img = _seeded_image(side, kind, side)
    got = timage.pil_to_array(img, min_size=1024)
    want = jimage.pil_to_array(img, min_size=1024)
    assert got[0].shape == want[0].shape and got[0].shape[0] == 1024
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
