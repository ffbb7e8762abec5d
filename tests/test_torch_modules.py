"""Each module of the PyTorch port held against its JAX counterpart at tiny
geometry, fp32 on the CPU: the JAX Flax parameters (randomized) go through
params_from_jax into the port with strict=True, the inputs are the same
numpy arrays. Also: JAX tree -> params_from_jax -> the JAX converter ->
JAX tree is bit-exact for every family."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.sdxl.control import ControlledUNet as JCUNet
from rsvldm_tpu.models.sdxl.control import GLVControl as JControl
from rsvldm_tpu.models.sdxl.denoiser import ControlDenoiser as JDenoiser
from rsvldm_tpu.models.sr3.unet import SR3UNet as JSR3UNet
from rsvldm_tpu.models.text.clip import CLIPTextTransformer as JCLIP
from rsvldm_tpu.models.text.conditioner import SDXLConditioner as JCond
from rsvldm_tpu.models.vae.model import AutoencoderKL as JVAE
from rsvldm_tpu.utils import convert, convert_hf
from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
from rsvldm_tpu_torch.models.sdxl.denoiser import ControlDenoiser
from rsvldm_tpu_torch.models.sr3.unet import SR3UNet
from rsvldm_tpu_torch.models.text.clip import CLIPTextTransformer
from rsvldm_tpu_torch.models.text.conditioner import SDXLConditioner
from rsvldm_tpu_torch.models.vae.model import AutoencoderKL
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, assert_close, japply, nchw, nhwc,
                              randomize, to_np)

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
LAT, T_CTX = 8, 7  # latent side, context tokens


def _port(cls, family, tree, cfg):
    m = cls(cfg)
    m.load_state_dict(params_from_jax(family, tree, cfg), strict=True)
    return m.eval().requires_grad_(False)


def _init(module, seed, *args):
    """Shapes of the Flax tree only (no init compute), then random values."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return randomize(shapes, seed)


def _ctx(n=2):
    cfg = JAX_TINY["sdxl"]
    return (RNG.standard_normal((n, T_CTX, cfg.context_dim)).astype(np.float32),
            RNG.standard_normal((n, cfg.adm_in_channels)).astype(np.float32))


# ------------------------------------------------------------------ SR3
@pytest.fixture(scope="module")
def sr3():
    jm = JSR3UNet(JAX_TINY["sr3"])
    tree = _init(jm, 1, jnp.zeros((1, 16, 16, 6)), jnp.ones((1, 1)))
    return jm, to_np(tree)


def test_sr3_unet(sr3):
    jm, tree = sr3
    x = RNG.standard_normal((2, 16, 16, 6)).astype(np.float32)
    nl = np.array([[0.3], [0.9]], np.float32)
    want = japply(jm, tree, jnp.asarray(x), jnp.asarray(nl))
    got = _port(SR3UNet, "sr3", tree, TORCH_TINY["sr3"])(nchw(x), torch.from_numpy(nl))
    assert_close(nhwc(got), want)


# ------------------------------------------------------------------ VAE
@pytest.fixture(scope="module")
def vae():
    jm = JVAE(JAX_TINY["vae"])
    tree = to_np(_init(jm, 2, jnp.zeros((1, 32, 32, 3))))
    return jm, tree, _port(AutoencoderKL, "vae", tree, TORCH_TINY["vae"])


@pytest.mark.parametrize("method", ["encode", "encode_with_denoise", "sample"])
def test_vae_encode(vae, method):
    jm, tree, tm = vae
    x = RNG.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    if method == "sample":
        key = jax.random.PRNGKey(5)
        want = japply(jm, tree, jnp.asarray(x), key, method=jm.encode)
        eps = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
        got = tm.encode(nchw(x), noise=nchw(eps))
    else:
        want = japply(jm, tree, jnp.asarray(x), method=getattr(jm, method))
        got = getattr(tm, method)(nchw(x))
    assert_close(nhwc(got), want)


def test_vae_decode(vae):
    jm, tree, tm = vae
    z = RNG.standard_normal((1, 16, 16, 4)).astype(np.float32) * 0.2
    want = japply(jm, tree, jnp.asarray(z), method=jm.decode)
    assert_close(nhwc(tm.decode(nchw(z))), want)


# ----------------------------------------------------------------- text
@pytest.fixture(scope="module")
def towers():
    toks = jnp.zeros((1, 77), jnp.int32)
    out = {}
    for fam, seed in (("clip_l", 3), ("big_g", 4)):
        jm = JCLIP(JAX_TINY[fam])
        tree = to_np(_init(jm, seed, toks))
        out[fam] = (jm, tree, _port(CLIPTextTransformer, fam, tree, TORCH_TINY[fam]))
    return out


def _tokens(n=2):
    t = np.zeros((n, 77), np.int64)
    for i in range(n):
        m = 5 + 7 * i
        t[i, 0] = 1
        t[i, 1:m] = RNG.integers(2, 990, m - 1)
        t[i, m] = 999
    return t


@pytest.mark.parametrize("fam", ["clip_l", "big_g"])
def test_clip_text(towers, fam):
    jm, tree, tm = towers[fam]
    toks = _tokens()
    want = japply(jm, tree, jnp.asarray(toks, jnp.int32))
    got = tm(torch.from_numpy(toks))
    for k in ("penultimate", "last", "pooled"):
        assert_close(got[k].numpy(), want[k])


def test_conditioner_paired(towers):
    (jl, pl, tl), (jg, pg, tg) = towers["clip_l"], towers["big_g"]
    tc, tu = _tokens(), _tokens()
    ctrl = RNG.standard_normal((2, LAT, LAT, 4)).astype(np.float32)
    jc, juc = jax.jit(JCond(jl, jg, pl, pg).paired)(
        *(jnp.asarray(t, jnp.int32) for t in (tc, tc, tu, tu)), jnp.asarray(ctrl))
    c, uc = SDXLConditioner(tl, tg).paired(
        *(torch.from_numpy(t) for t in (tc, tc, tu, tu)), torch.from_numpy(ctrl))
    for got, want in ((c, jc), (uc, juc)):
        for k in ("crossattn", "vector", "control"):
            assert_close(got[k].numpy(), want[k])


# ----------------------------------------------------------------- SDXL
@pytest.fixture(scope="module")
def sdxl():
    cfg = JAX_TINY["sdxl"]
    lat = jnp.zeros((1, LAT, LAT, 4))
    t = jnp.zeros((1,))
    ctx = jnp.zeros((1, T_CTX, cfg.context_dim))
    y = jnp.zeros((1, cfg.adm_in_channels))
    jctrl = JControl(cfg)
    ctree = to_np(_init(jctrl, 6, lat, lat, t, ctx, y))
    feats = jax.eval_shape(jctrl.apply, ctree, lat, lat, t, ctx, y)
    junet = JCUNet(cfg)
    utree = to_np(_init(junet, 7, lat, t, ctx, y, feats))
    tcfg = TORCH_TINY["sdxl"]
    return dict(jctrl=jctrl, ctree=ctree, junet=junet, utree=utree,
                ctrl=_port(GLVControl, "control", ctree, tcfg),
                unet=_port(ControlledUNet, "unet", utree, tcfg))


def _sdxl_inputs():
    x = RNG.standard_normal((2, LAT, LAT, 4)).astype(np.float32)
    lq = RNG.standard_normal((2, LAT, LAT, 4)).astype(np.float32)
    ts = np.array([10, 700], np.int32)
    ctx, y = _ctx()
    return x, lq, ts, ctx, y


def test_glv_control(sdxl):
    x, lq, ts, ctx, y = _sdxl_inputs()
    want = japply(sdxl["jctrl"], sdxl["ctree"], *(jnp.asarray(a) for a in (lq, x, ts, ctx, y)))
    got = sdxl["ctrl"](nchw(lq), nchw(x), torch.from_numpy(ts),
                       torch.from_numpy(ctx), torch.from_numpy(y))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(nhwc(g), w)


def test_controlled_unet_stages(sdxl):
    x, lq, ts, ctx, y = _sdxl_inputs()
    junet, utree = sdxl["junet"], sdxl["utree"]
    jfeats = japply(sdxl["jctrl"], sdxl["ctree"], *(jnp.asarray(a) for a in (lq, x, ts, ctx, y)))
    jh, jhs, jemb = japply(junet, utree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                jnp.asarray(y), method=junet.input_stage)
    want = japply(junet, utree, jh, jhs, jemb, jnp.asarray(ctx), jfeats, 0.7,
                       method=junet.rest_stage)
    tfeats = sdxl["ctrl"](nchw(lq), nchw(x), torch.from_numpy(ts),
                          torch.from_numpy(ctx), torch.from_numpy(y))
    h, hs, emb = sdxl["unet"].input_stage(nchw(x), torch.from_numpy(ts),
                                          torch.from_numpy(ctx), torch.from_numpy(y))
    assert_close(nhwc(h), jh)
    for g, w in zip(hs, jhs):
        assert_close(nhwc(g), w)
    got = sdxl["unet"].rest_stage(h, hs, emb, torch.from_numpy(ctx), tfeats, 0.7)
    assert_close(nhwc(got), want)


def test_control_denoiser(sdxl):
    x, lq, _, ctx, y = _sdxl_inputs()
    sigma = np.array([3.0, 0.4], np.float32)
    jd = JDenoiser(unet=sdxl["junet"], control_net=sdxl["jctrl"],
                   unet_params=sdxl["utree"], control_params=sdxl["ctree"])
    jcond = dict(crossattn=jnp.asarray(ctx), vector=jnp.asarray(y), control=jnp.asarray(lq))
    args = (jnp.asarray(x), jnp.asarray(sigma), jcond)

    def first_rest(x, sigma, cond):
        part = jd.first(x, sigma, cond)
        return part.h, jd.rest(part, cond, 1.0)

    jh, want = jax.jit(first_rest)(*args)
    td = ControlDenoiser(unet=sdxl["unet"], control_net=sdxl["ctrl"])
    tcond = dict(crossattn=torch.from_numpy(ctx), vector=torch.from_numpy(y),
                 control=nchw(lq))
    tp = td.first(nchw(x), torch.from_numpy(sigma), tcond)
    assert tuple(tp.h.shape) == td.first_block_shape(2, LAT, LAT)
    assert_close(nhwc(tp.h), jh)
    assert_close(nhwc(td.rest(tp, tcond, 1.0)), want)


# ----------------------------------------------------------- round trip
def _roundtrip_cases():
    return ["sr3", "vae", "control", "unet", "clip_l", "big_g"]


@pytest.mark.parametrize("family", _roundtrip_cases())
def test_params_from_jax_roundtrip_bit_exact(family, sr3, vae, towers, sdxl):
    tree = {"sr3": sr3[1], "vae": vae[1], "control": sdxl["ctree"],
            "unet": sdxl["utree"], "clip_l": towers["clip_l"][1],
            "big_g": towers["big_g"][1]}[family]
    jcfg = {"sr3": JAX_TINY["sr3"], "vae": JAX_TINY["vae"],
            "control": JAX_TINY["sdxl"], "unet": JAX_TINY["sdxl"],
            "clip_l": JAX_TINY["clip_l"], "big_g": JAX_TINY["big_g"]}[family]
    tcfg = {"control": TORCH_TINY["sdxl"], "unet": TORCH_TINY["sdxl"]}.get(
        family, TORCH_TINY.get(family))
    sd = params_from_jax(family, tree, tcfg)
    back = {"sr3": convert.convert_sr3_unet, "vae": convert.convert_autoencoder,
            "control": convert.convert_glv_control,
            "unet": convert.convert_controlled_unet,
            "clip_l": convert_hf.convert_hf_clip_text,
            "big_g": convert_hf.convert_openclip_text}[family](sd, jcfg)
    want, want_def = jax.tree_util.tree_flatten(tree)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert want_def == got_def
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
