"""The reference components the pipeline does not call, held against the JAX
package on the CPU: PreparedConditioner (its .npz files read and written by
both packages), the eps / v / EDM scalings, DiagonalGaussian.kl and
degrade_image. Inputs from numpy seeds, tiny text towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.diffusion import scalings as jscalings
from rsvldm_tpu.models.text.clip import CLIPTextTransformer as JCLIP
from rsvldm_tpu.models.text.conditioner import PreparedConditioner as JPrepared
from rsvldm_tpu.models.text.conditioner import SDXLConditioner as JCond
from rsvldm_tpu.models.vae.model import DiagonalGaussian as JGaussian
from rsvldm_tpu.ops.image import degrade_image as jdegrade
from rsvldm_tpu_torch.diffusion import scalings
from rsvldm_tpu_torch.models.text.clip import CLIPTextTransformer
from rsvldm_tpu_torch.models.text.conditioner import (PreparedConditioner,
                                                      SDXLConditioner)
from rsvldm_tpu_torch.models.vae.model import DiagonalGaussian
from rsvldm_tpu_torch.ops.image import degrade_image
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import JAX_TINY, TORCH_TINY, assert_close, randomize, to_np

torch.set_num_threads(1)
LAT = 8  # the control latent's side
KEYS = ("crossattn_c", "vector_c", "crossattn_uc", "vector_uc")


# ------------------------------------------------------ PreparedConditioner
@pytest.fixture(scope="module")
def conditioners():
    """The JAX SDXLConditioner at the tiny widths and the port's over the
    same weights, and one prompt pair's tokens (cond, uncond)."""
    toks = jnp.zeros((1, 77), jnp.int32)
    jax_towers, port_towers = [], []
    for fam, seed in (("clip_l", 3), ("big_g", 4)):
        jm = JCLIP(JAX_TINY[fam])
        tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), toks),
                               seed))
        tm = CLIPTextTransformer(TORCH_TINY[fam])
        tm.load_state_dict(params_from_jax(fam, tree, TORCH_TINY[fam]), strict=True)
        jax_towers.append((jm, tree))
        port_towers.append(tm.eval().requires_grad_(False))
    rng = np.random.default_rng(20)
    tokens = []
    for m in (9, 4):
        t = np.zeros((1, 77), np.int64)
        t[0, 0], t[0, 1:m], t[0, m] = 1, rng.integers(2, 990, m - 1), 999
        tokens.append(t)
    (jl, pl), (jg, pg) = jax_towers
    return JCond(jl, jg, pl, pg), SDXLConditioner(*port_towers), tokens


def _controls(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, LAT, LAT, 4)).astype(np.float32),
            rng.standard_normal((3, LAT, LAT, 4)).astype(np.float32))


def test_prepared_from_jax_file(conditioners, tmp_path):
    """JAX saves its live conditioning; the port loads the file on the CPU,
    and its paired() over 3 rows equals JAX's PreparedConditioner bit for
    bit, every row equal to JAX's live row 0."""
    jcond, _, (tc, tu) = conditioners
    ctrl1, ctrl3 = _controls(1)
    j = lambda t: jnp.asarray(t, jnp.int32)
    c, uc = jax.jit(jcond.paired)(j(tc), j(tc), j(tu), j(tu), jnp.asarray(ctrl1))
    path = str(tmp_path / "jax.npz")
    JPrepared.save(path, c, uc)
    want = JPrepared.load(path).paired(jnp.asarray(ctrl3))
    got = PreparedConditioner.load(path, device="cpu").paired(torch.from_numpy(ctrl3))
    for g, w, live in zip(got, want, (c, uc)):
        for k in ("crossattn", "vector", "control"):
            assert g[k].dtype == torch.float32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        for k in ("crossattn", "vector"):
            np.testing.assert_array_equal(
                g[k].numpy(), np.repeat(np.asarray(live[k])[:1], 3, axis=0))


def test_prepared_to_jax_file(conditioners, tmp_path):
    """The port saves its live conditioning as four float32 arrays; JAX's
    PreparedConditioner loads them and its paired() equals JAX's live
    conditioning within 1e-4 (the towers' fp32 summation order)."""
    jcond, tcond, (tc, tu) = conditioners
    ctrl1, ctrl3 = _controls(2)
    c, uc = tcond.paired(*(torch.from_numpy(t) for t in (tc, tc, tu, tu)),
                         torch.from_numpy(ctrl1))
    path = str(tmp_path / "port.npz")
    PreparedConditioner.save(path, c, uc)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(KEYS)
        assert all(z[k].dtype == np.float32 for k in KEYS)
    j = lambda t: jnp.asarray(np.repeat(t, 3, axis=0), jnp.int32)
    want = jax.jit(jcond.paired)(j(tc), j(tc), j(tu), j(tu), jnp.asarray(ctrl3))
    got = JPrepared.load(path).paired(jnp.asarray(ctrl3))
    for g, w in zip(got, want):
        for k in ("crossattn", "vector", "control"):
            assert_close(np.asarray(g[k]), np.asarray(w[k]))


def test_prepared_missing_key_raises(tmp_path):
    path = str(tmp_path / "partial.npz")
    z = np.zeros((1, 77, 8), np.float32)
    np.savez(path, crossattn_c=z, vector_c=z[:, 0], crossattn_uc=z)
    with pytest.raises(KeyError):
        PreparedConditioner.load(path, device="cpu")


def test_prepared_control_without_batch_axis_raises():
    z = np.zeros((1, 77, 8), np.float32)
    prep = PreparedConditioner(z, z[:, 0], z, z[:, 0], device="cpu")
    with pytest.raises(IndexError):
        prep.paired(torch.tensor(1.0))


def test_prepared_device_and_dtype():
    """The card by default, raising where there is none; crossattn in the
    asked dtype, the vectors fp32 as SDXLConditioner builds them."""
    z = np.random.default_rng(3).standard_normal((1, 77, 8)).astype(np.float32)
    if torch.cuda.is_available():
        assert PreparedConditioner(z, z[:, 0], z, z[:, 0]).vector_c.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PreparedConditioner(z, z[:, 0], z, z[:, 0])
    prep = PreparedConditioner(z, z[:, 0], z, z[:, 0], device="cpu",
                               dtype=torch.bfloat16)
    c, uc = prep.paired(torch.zeros(2, LAT, LAT, 4))
    for d in (c, uc):
        assert d["crossattn"].dtype == torch.bfloat16
        assert d["vector"].dtype == torch.float32
        assert d["crossattn"].shape == (2, 77, 8) and d["vector"].shape == (2, 8)


# ---------------------------------------------------------------- scalings
SIGMAS = np.geomspace(0.03, 14.61, 41).astype(np.float32)


def test_scalings_table():
    assert sorted(scalings.SCALINGS) == sorted(jscalings.SCALINGS) == ["edm", "eps", "v"]


@pytest.mark.parametrize("name", ["eps", "v", "edm"])
def test_scaling_matches_jax(name):
    """(c_skip, c_out, c_in, c_noise) at sigmas 0.03 to 14.61, fp32, to a
    relative 1e-6 of JAX's."""
    want = jscalings.SCALINGS[name](jnp.asarray(SIGMAS))
    got = scalings.SCALINGS[name](torch.from_numpy(SIGMAS))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == SIGMAS.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_edm_scaling_sigma_data():
    want = jscalings.edm_scaling(jnp.asarray(SIGMAS), sigma_data=1.3)
    got = scalings.edm_scaling(torch.from_numpy(SIGMAS), sigma_data=1.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ---------------------------------------------------------------- KL
# logvar ranges: (-40, 25) clamps on both sides, where exp(20) dominates the
# sum; (-40, -25) leaves -logvar to dominate, so the lower clamp shows;
# (-3, 3) weighs the mean, exp and logvar terms alike
@pytest.mark.parametrize("lo,hi", [(-40.0, 25.0), (-40.0, -25.0), (-3.0, 3.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kl_matches_jax(dtype, lo, hi):
    """NHWC moments [2, 8, 8, 8], logvar drawn from (lo, hi); the port's
    NCHW kl in fp32 [N] to a relative 1e-5 of JAX's on the same (for bf16,
    bf16-rounded) values."""
    rng = np.random.default_rng(7)
    m = np.concatenate([rng.standard_normal((2, 8, 8, 4)),
                        rng.uniform(lo, hi, (2, 8, 8, 4))], -1).astype(np.float32)
    t = torch.from_numpy(m).permute(0, 3, 1, 2).to(dtype)
    want = np.asarray(JGaussian(jnp.asarray(t.float().permute(0, 2, 3, 1).numpy())).kl())
    got = DiagonalGaussian(t).kl()
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------- degrade
@pytest.mark.parametrize("size", [(37, 29), (64, 48)])
@pytest.mark.parametrize("factor", [1.5, 2, 3.7])
def test_degrade_image_bytes(size, factor):
    rng = np.random.default_rng(size[0] * 10 + int(factor * 10))
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8), "RGB")
    got, want = degrade_image(img, factor), jdegrade(img, factor)
    assert got.size == want.size == img.size and got.mode == "RGB"
    assert got.tobytes() == want.tobytes()
