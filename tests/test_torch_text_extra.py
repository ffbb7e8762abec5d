"""The port's T5 encoder, resamplers and sgm embedders held against the
JAX package, fp32 on the CPU, with the same seeded Flax trees and JAX's
draws injected (masked_drop's uniforms, LowScaleEncoder's noise levels and
normals, gaussian_encode's normals): T5 (gated and ReLU FFN) and its
relative-position bucket table, exactly; spatial_pool, masked_drop, the
Q-Former, the perceiver (with and without its FFN), build_resampler;
ClassEmbedder, SpatialRescaler (nearest, bilinear, bicubic, the channel
mapper), LowScaleEncoder, gaussian_encode, ImageEmbedder and
byt5_tokenize. (The params_from_jax round trips:
tests/test_torch_weights_families.py.)

Tolerance: 1e-4 of max(1, |out|) (torch_parity_lib.assert_close)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.diffusion.schedules import make_beta_schedule
from rsvldm_tpu.models.text import embedders as jemb
from rsvldm_tpu.models.text import t5 as jt5
from rsvldm_tpu.models.vlm import resampler as jres
from rsvldm_tpu_torch.models.text import embedders as temb
from rsvldm_tpu_torch.models.text import t5 as tt5
from rsvldm_tpu_torch.models.vlm import resampler as tres
from rsvldm_tpu_torch.utils import prng
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import assert_close, japply, randomize, to_np

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


# --------------------------------------------------------------------- T5
@pytest.mark.parametrize("gated", [True, False])
def test_t5_equal_jax(gated):
    kw = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=37, layers=2, heads=4,
              gated_ff=gated)
    jcfg, tcfg = jt5.T5Config(**kw), tt5.T5Config(**kw)
    jm = jt5.T5Encoder(jcfg)
    toks = RNG.integers(0, 100, (2, 77)).astype(np.int32)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(toks)), 70))
    sd = params_from_jax("t5", tree, tcfg)
    tm = _load(tt5.T5Encoder(tcfg), sd)
    assert_close(tm(torch.from_numpy(toks).long()).numpy(),
                 japply(jm, tree, jnp.asarray(toks)))


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 64), (64, 512)])
def test_relative_position_buckets_exactly_jax(buckets, max_distance):
    """The whole table for offsets -1023..1023 (a 1024-token prompt), the
    fp32 log's truncation included."""
    rel = np.arange(-1023, 1024, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), buckets,
                                                   max_distance))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), buckets,
                                       max_distance).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- resamplers
@pytest.mark.parametrize("mode", ["average", "max"])
def test_spatial_pool_equal_jax(mode):
    x = RNG.standard_normal((2, 16, 6)).astype(np.float32)
    want = jres.spatial_pool(jnp.asarray(x), stride=2, mode=mode)
    got = tres.spatial_pool(torch.from_numpy(x), stride=2, mode=mode)
    assert_close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("ratio", [0.5, 0.3, 0.0])
def test_masked_drop_with_jax_draws(ratio):
    x = RNG.standard_normal((3, 20, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jres.masked_drop(jnp.asarray(x), key, ratio=ratio)
    draws = torch.from_numpy(np.array(jax.random.uniform(key, (3, 20))))
    got = tres.masked_drop(torch.from_numpy(x), draws, ratio=ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same from the key alone
    got = tres.masked_drop(torch.from_numpy(x), ratio=ratio, key=prng.key(7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tres.masked_drop(torch.from_numpy(x), None, deterministic=True) \
        .shape == x.shape


def test_qformer_equal_jax():
    kw = dict(hidden_size=32, layers=4, heads=4, intermediate=64,
              encoder_width=24, num_latents=8, cross_attention_freq=2)
    jcfg, tcfg = jres.QFormerConfig(**kw), tres.QFormerConfig(**kw)
    jm = jres.QFormerResampler(jcfg)
    x = RNG.standard_normal((2, 10, 24)).astype(np.float32)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 71))
    sd = params_from_jax("qformer", tree, tcfg)
    tm = _load(tres.QFormerResampler(tcfg), sd)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 8, 32)
    assert_close(got.numpy(), japply(jm, tree, jnp.asarray(x)))


@pytest.mark.parametrize("ff_mult", [2, 0])
def test_perceiver_equal_jax(ff_mult):
    kw = dict(dim=24, depth=2, dim_head=4, heads=8, num_latents=8,
              ff_mult=ff_mult)
    jcfg, tcfg = jres.PerceiverConfig(**kw), tres.PerceiverConfig(**kw)
    jm = jres.PerceiverResampler(jcfg)
    x = RNG.standard_normal((2, 10, 24)).astype(np.float32)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 72))
    sd = params_from_jax("perceiver", tree, tcfg)
    tm = _load(tres.PerceiverResampler(tcfg), sd)
    assert_close(tm(torch.from_numpy(x)).numpy(), japply(jm, tree, jnp.asarray(x)))


def test_build_resampler_dispatch():
    x = torch.from_numpy(RNG.standard_normal((1, 16, 4)).astype(np.float32))
    assert tres.build_resampler(None)(x) is x
    assert tres.build_resampler("spatial_pool", stride=2)(x).shape == (1, 4, 4)
    drop = tres.build_resampler("masked_drop", ratio=0.25)
    assert drop(x, noise=torch.rand(1, 16)).shape == (1, 12, 4)
    assert isinstance(tres.build_resampler("perceiver", dim=8, depth=1,
                                           dim_head=4, heads=2, num_latents=4),
                      tres.PerceiverResampler)
    assert isinstance(tres.build_resampler("qformer", hidden_size=8, layers=1,
                                           heads=2, intermediate=16,
                                           encoder_width=4, num_latents=2),
                      tres.QFormerResampler)
    with pytest.raises(ValueError):
        tres.build_resampler("nope")


# --------------------------------------------------------------- embedders
def test_class_embedder_equal_jax():
    jm = jemb.ClassEmbedder(embed_dim=8, n_classes=10, add_sequence_dim=True)
    c = np.array([1, 9, 3], np.int32)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(c)), 73))
    tm = temb.ClassEmbedder(8, 10, add_sequence_dim=True)
    tm.embedding.weight.data = torch.from_numpy(
        np.asarray(tree["params"]["embedding"]["embedding"]))
    np.testing.assert_array_equal(tm(torch.from_numpy(c).long()).detach().numpy(),
                                  np.asarray(jm.apply(tree, jnp.asarray(c))))
    assert tm.unconditional_class() == jm.unconditional_class() == 9


@pytest.mark.parametrize("method,stages,mult,side", [
    ("bilinear", 2, 0.5, 16), ("nearest", 1, 0.5, 15), ("bicubic", 1, 0.5, 16),
    ("bilinear", 1, 2.0, 6), ("nearest", 1, 1.5, 6), ("bicubic", 1, 2.0, 5)])
def test_spatial_rescaler_equal_jax(method, stages, mult, side):
    x = RNG.standard_normal((2, side, side, 3)).astype(np.float32)
    jm = jemb.SpatialRescaler(n_stages=stages, method=method, multiplier=mult)
    want = jm.apply({}, jnp.asarray(x))
    got = temb.SpatialRescaler(stages, method, mult)(torch.from_numpy(x))
    assert got.shape == want.shape
    assert_close(got.numpy(), want, 1e-5)


def test_spatial_rescaler_channel_mapper_equal_jax():
    x = RNG.standard_normal((1, 16, 16, 3)).astype(np.float32)
    jm = jemb.SpatialRescaler(out_channels=7, kernel_size=3, use_bias=True)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 74))
    tm = temb.SpatialRescaler(in_channels=3, out_channels=7, kernel_size=3,
                              use_bias=True)
    cm = tree["params"]["channel_mapper"]
    tm.channel_mapper.weight.data = torch.from_numpy(
        np.asarray(cm["kernel"]).transpose(3, 2, 0, 1).copy())
    tm.channel_mapper.bias.data = torch.from_numpy(np.asarray(cm["bias"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got.numpy(), jm.apply(tree, jnp.asarray(x)))


def test_lowscale_encoder_with_jax_draws():
    betas = make_beta_schedule("linear", 100, 1e-4, 2e-2)
    enc_fn = lambda x: x[:, ::2, ::2, :1]
    kw = dict(max_noise_level=50, out_size=4, scale_factor=0.5)
    jenc = jemb.LowScaleEncoder(encode_fn=enc_fn, betas=jnp.asarray(betas), **kw)
    tenc = temb.LowScaleEncoder(encode_fn=enc_fn, betas=torch.from_numpy(
        np.asarray(betas)), **kw)
    x = RNG.standard_normal((2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    zj, tj = jenc(jnp.asarray(x), key)
    k1, k2 = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k1, (2,), 0, 50)))
    noise = torch.from_numpy(np.array(jax.random.normal(k2, (2, 8, 8, 1))))
    zt, tt = tenc(torch.from_numpy(x), t.long(), noise)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert_close(zt.numpy(), zj, 1e-6)
    # the same from the key alone
    zt, tt = tenc(torch.from_numpy(x), key=prng.key(5))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert_close(zt.numpy(), zj, 1e-6)


def test_gaussian_encode_with_jax_draws():
    def enc(x):
        return x[..., :4] * 0.5

    x = RNG.standard_normal((2, 4, 4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jlog, zj = jemb.gaussian_encode(enc, jnp.asarray(x), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 4, 4, 2))))
    tlog, zt = temb.gaussian_encode(enc, torch.from_numpy(x), noise)
    assert_close(zt.numpy(), zj, 1e-6)
    _, zk = temb.gaussian_encode(enc, torch.from_numpy(x), key=prng.key(2))
    assert_close(zk.numpy(), zj, 1e-6)
    np.testing.assert_allclose(float(tlog["kl_loss"]), float(jlog["kl_loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("pool,rep", [("cls", 0), ("mean", 5)])
def test_image_embedder_equal_jax(pool, rep):
    w = RNG.standard_normal((3, 8)).astype(np.float32)
    jv = lambda px: jnp.einsum("nhwc,cd->nhwd", px, jnp.asarray(w)).reshape(
        px.shape[0], -1, 8)
    tv = lambda px: torch.einsum("nhwc,cd->nhwd", px, torch.from_numpy(w)).reshape(
        px.shape[0], -1, 8)
    imgs = RNG.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32)
    mask = np.array([1, 0], np.float32)
    want = jemb.ImageEmbedder(jv, pool=pool, repeat_to_max_len=rep)(
        jnp.asarray(imgs), ucg_mask=jnp.asarray(mask))
    got = temb.ImageEmbedder(tv, pool=pool, repeat_to_max_len=rep)(
        torch.from_numpy(imgs), ucg_mask=torch.from_numpy(mask))
    assert_close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("text,n", [("Ab", 6), ("héllo wörld", 77), ("x" * 90, 77)])
def test_byt5_tokenize_equal_jax(text, n):
    np.testing.assert_array_equal(temb.byt5_tokenize(text, n).numpy(),
                                  np.asarray(jemb.byt5_tokenize(text, n)))
