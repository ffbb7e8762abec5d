"""The port's tiled VAE (models/vae/tiled.py, the tile-collective GroupNorm
of ops/norm.py and the tiled branch of the pipeline's Stage 2b) held
against the JAX package's at tiny geometry, fp32 on the CPU: tile plans,
split and stitch (exact), tile-collective GroupNorm on overlapping tiles
(1e-5) and, on disjoint tiles, equal to whole-image GroupNorm; tiled
encode and decode of a tiny VAE with three downsamples (1e-4 scaled);
run_refinement with use_tile_vae and overlapping tiles, and
run_refinement_batch taking the per-image route, both with JAX's weights
and draws: PNGs within 1 uint8 level; a batch of two refused by
split_tiles, as JAX does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.config import (PipelineConfig as JPipelineConfig,
                               RefinementConfig as JRefinementConfig)
from rsvldm_tpu.models.vae import tiled as jtiled
from rsvldm_tpu.models.vae.model import AutoencoderKL as JVAE
from rsvldm_tpu.models.vae.model import VAEConfig as JVAEConfig
from rsvldm_tpu.ops.norm import GroupNorm32 as JGroupNorm32
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu_torch.config import PipelineConfig, RefinementConfig
from rsvldm_tpu_torch.models.vae import tiled
from rsvldm_tpu_torch.models.vae.model import AutoencoderKL, VAEConfig
from rsvldm_tpu_torch.ops.norm import GroupNorm32, tile_collective_gn
from rsvldm_tpu_torch.pipeline import ReplayNoise, SuperResolutionPipeline
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, assert_close, nchw, nhwc,
                              randomize, to_np)

torch.set_num_threads(1)
# three downsamples (the SDXL VAE's factor 8, which the tiled stitch
# assumes), 32 and 64 channels: GroupNorm groups of one and two channels
_VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
JV, TV = JVAEConfig(**_VAE), VAEConfig(**_VAE)
RNG = np.random.default_rng(0)


@pytest.mark.parametrize("size,tile", [(64, 64), (100, 64), (192, 64),
                                       (128, 48), (16, 6), (5, 8)])
def test_plan_tiles_equal_jax(size, tile):
    assert tiled.plan_tiles(size, tile) == jtiled.plan_tiles(size, tile)


@pytest.mark.parametrize("hw,tile,pad,scale", [
    ((24, 40), 8, 4, (1, 1)), ((64, 80), 32, 16, (1, 8)),
    ((10, 16), 4, 11, (8, 1)), ((7, 7), 8, 2, (1, 1))])
def test_split_and_stitch_equal_jax(hw, tile, pad, scale):
    """Tiles (edge-padded halos, the last row and column shifted in) and
    the stitch of a per-tile transform (cores placed in order, scaled
    coordinates floor-divided) equal JAX's exactly."""
    x = RNG.standard_normal((1, *hw, 3)).astype(np.float32)
    jt, jgrid = jtiled.split_tiles(jnp.asarray(x), tile, pad)
    tt, grid = tiled.split_tiles(torch.from_numpy(x).permute(0, 3, 1, 2), tile, pad)
    assert grid == jgrid
    np.testing.assert_array_equal(nhwc(tt), np.asarray(jt))
    num, den = scale
    # a per-tile stand-in for the VAE: nearest resize by num / den
    resize = lambda t, n=tt.shape[2] * num // den: torch.nn.functional.interpolate(
        t, size=(n, n), mode="nearest")
    yt = resize(tt) + torch.arange(len(grid))[:, None, None, None]
    out_hw = (hw[0] * num // den, hw[1] * num // den)
    want = jtiled.stitch_tiles(jnp.asarray(nhwc(yt)), jgrid, out_hw, pad, num, den)
    got = tiled.stitch_tiles(yt, grid, out_hw, pad, num, den)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_split_tiles_refuses_a_batch():
    """The tile axis pools one image's statistics: a batch of two raises,
    with JAX's message."""
    with pytest.raises(AssertionError, match="per-image"):
        tiled.split_tiles(torch.zeros(2, 3, 64, 64), 32, 16)
    with pytest.raises(AssertionError, match="per-image"):
        jtiled.split_tiles(jnp.zeros((2, 64, 64, 3)), 32, 16)


def _gn_pair(c, groups, seed):
    jm = JGroupNorm32(num_groups=groups)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 4, 4, c))), seed))
    tm = GroupNorm32(c, num_groups=groups)
    tm.weight.data = torch.from_numpy(np.array(tree["params"]["scale"]))
    tm.bias.data = torch.from_numpy(np.array(tree["params"]["bias"]))
    return jm, tree, tm


@pytest.mark.parametrize("c,groups", [(8, 4), (64, 32), (6, 32)])
def test_tile_collective_gn_equal_jax_on_overlapping_tiles(c, groups):
    """Overlapping halo-padded tiles of one image (split_tiles), an offset
    mean: the pooled statistics (every tile, overlaps counted each time)
    equal JAX's within 1e-5; outside the switch each tile is normalised on
    its own, also as JAX."""
    x = (RNG.standard_normal((1, 20, 28, c)) * 2 + 3).astype(np.float32)
    jt, _ = jtiled.split_tiles(jnp.asarray(x), 8, 4)
    jm, tree, tm = _gn_pair(c, groups, 5)
    tt = nchw(np.asarray(jt))
    with jtiled.tile_collective_gn():
        want = np.asarray(jm.apply(tree, jt))
    with tile_collective_gn():
        got = tm(tt)
    assert_close(nhwc(got), want, 1e-5)
    assert_close(nhwc(tm(tt)), np.asarray(jm.apply(tree, jt)), 1e-5)
    assert not np.allclose(nhwc(got), nhwc(tm(tt)), atol=1e-3)


def test_tile_collective_gn_on_disjoint_tiles_equals_whole_image():
    x = torch.from_numpy(RNG.standard_normal((1, 32, 8, 16)).astype(np.float32))
    _, _, gn = _gn_pair(32, 32, 6)
    whole = gn(x)
    tiles = torch.cat([x[..., :8], x[..., 8:]], dim=0)
    with tile_collective_gn():
        out = gn(tiles)
    torch.testing.assert_close(torch.cat([out[0:1], out[1:2]], dim=3), whole,
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def vae():
    jm = JVAE(JV)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3))), 41))
    tm = AutoencoderKL(TV)
    tm.load_state_dict(params_from_jax("vae", tree, TV), strict=True)
    return jm, tree, tm.eval().requires_grad_(False)


def test_tiled_encode_equal_jax(vae):
    """64 x 80 image, 32-px tiles (the columns overlap), the 32-px halo:
    the latent of the twin encoder, tiled, equals JAX's."""
    jm, tree, tm = vae
    x = (RNG.standard_normal((1, 64, 80, 3)) * 0.5).astype(np.float32)
    want = jtiled.tiled_encode(lambda t: jm.apply(tree, t,
                                                  method=jm.encode_with_denoise),
                               jnp.asarray(x), tile=32)
    with torch.inference_mode():
        got = tiled.tiled_encode(tm.encode_with_denoise, nchw(x), tile=32)
    assert got.shape == (1, 4, 8, 10)
    assert_close(nhwc(got), np.asarray(want))


def test_tiled_decode_equal_jax(vae):
    """An 8 x 10 latent, 4-latent tiles (the columns overlap), the 11-px
    halo: the decoded image equals JAX's."""
    jm, tree, tm = vae
    z = (RNG.standard_normal((1, 8, 10, 4)) * 0.5).astype(np.float32)
    want = jtiled.tiled_decode(lambda t: jm.apply(tree, t, method=jm.decode),
                               jnp.asarray(z), tile=4)
    with torch.inference_mode():
        got = tiled.tiled_decode(tm.decode, nchw(z), tile=4)
    assert got.shape == (1, 3, 64, 80)
    assert_close(nhwc(got), np.asarray(want))


# ----------------------------------------------------------- pipeline
SEED, EDM_STEPS, SIDE = 3, 2, 128
FAMILIES = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
REFINE = dict(min_size=64, edm_steps=EDM_STEPS, size_bucket=0,
              use_tile_vae=True, encoder_tile_size=48, decoder_tile_size=10)


def _jax_draws(n_calls, latent):
    """The draws of n_calls JAX _refine_core calls from a fresh pipeline
    key (pipeline.py:456): k_enc for the posterior sample, k_noise the
    initial noise, k_loop folded per churn step."""
    rng = jax.random.PRNGKey(SEED)
    draws = {"vae_sample": [], "edm_init": [], "churn": []}
    normal = lambda k: np.asarray(jax.random.normal(k, latent, jnp.float32))
    for _ in range(n_calls):
        rng, k_enc, k_noise, k_loop = jax.random.split(rng, 4)
        draws["vae_sample"].append(normal(k_enc))
        draws["edm_init"].append(normal(k_noise))
        draws["churn"].append(np.stack([normal(jax.random.fold_in(k_loop, i))
                                        for i in range(EDM_STEPS)]))
    return draws


@pytest.fixture(scope="module")
def refined(tmp_path_factory):
    """JAX's run_refinement of one 128^2 image and run_refinement_batch of
    two, with tiles (9 encoder tiles of 48 px, 4 decoder tiles of 10
    latent px, overlapping), then the port's with JAX's weights and
    draws. The port records each _refine_core batch and run_refinement."""
    work = tmp_path_factory.mktemp("tiled_refine")
    rng = np.random.default_rng(7)
    imgs = [Image.fromarray((rng.random((SIDE, SIDE, 3)) * 255).astype("uint8"))
            for _ in range(3)]
    jcfgs = dict(JAX_TINY, vae=JV)
    mp = pytest.MonkeyPatch()
    mp.setattr(JPipeline, "_init_params", lambda self, what, init_fn: randomize(
        jax.eval_shape(init_fn, jax.random.PRNGKey(0)), 300 + FAMILIES.index(what)))
    try:
        jp = JPipeline(JPipelineConfig(ckpt_dir=str(work / "none"), seed=SEED,
                                       params_dtype="fp32", no_llava=True,
                                       refine=JRefinementConfig(**REFINE)),
                       model_cfgs=jcfgs)
        jp._ensure_stage2()
        trees = {fam: to_np(getattr(jp, f"{fam}_params")) for fam in FAMILIES}
        jouts = [jp.run_refinement(imgs[0], "a field")]
        jouts += jp.run_refinement_batch([(imgs[1], "a road"), (imgs[2], "a lake")])
    finally:
        mp.undo()
    tcfgs = dict(TORCH_TINY, vae=TV)
    sds = {fam: params_from_jax(fam, tree, tcfgs["sdxl" if fam in ("unet", "control")
                                                 else fam])
           for fam, tree in trees.items()}
    tp = SuperResolutionPipeline(
        PipelineConfig(ckpt_dir=str(work / "none"), seed=SEED,
                       params_dtype="fp32", no_llava=True,
                       refine=RefinementConfig(**REFINE)),
        device="cpu", model_cfgs=tcfgs, state_dicts=sds,
        noise=ReplayNoise(_jax_draws(3, (1, SIDE // 8, SIDE // 8, 4))))
    tp.batches, tp.singles = [], []
    core, single = tp._refine_core, tp.run_refinement
    tp._refine_core = lambda x, texts: tp.batches.append(x.shape[0]) or core(x, texts)
    tp.run_refinement = lambda *a, **k: tp.singles.append(1) or single(*a, **k)
    touts = [tp.run_refinement(imgs[0], "a field")]
    touts += tp.run_refinement_batch([(imgs[1], "a road"), (imgs[2], "a lake")])
    return jouts, touts, tp


def test_tiled_refinement_within_one_level_of_jax(refined):
    """use_tile_vae with overlapping tiles: the refined PNG of one image
    within 1 uint8 level of JAX's; its VAE preparation and final decode
    took the tiled branch (the image is wider than a tile)."""
    jouts, touts, tp = refined
    a, b = (np.asarray(o, np.int16) for o in (jouts[0], touts[0]))
    assert a.shape == b.shape == (SIDE, SIDE, 3) and a.std() > 0
    assert np.abs(a - b).max() <= 1
    assert tp._use_tiles((SIDE, SIDE)) and not tp._use_tiles((48, 48))


def test_refinement_batch_takes_the_per_image_route(refined):
    """run_refinement_batch of two images whose padded shape tiles: image
    by image through run_refinement (batches of one), as JAX does, and
    each PNG within 1 uint8 level of JAX's."""
    jouts, touts, tp = refined
    assert tp.batches == [1, 1, 1] and len(tp.singles) == 3
    for j, t in zip(jouts[1:], touts[1:]):
        a, b = np.asarray(j, np.int16), np.asarray(t, np.int16)
        assert a.shape == b.shape == (SIDE, SIDE, 3)
        assert np.abs(a - b).max() <= 1


def test_untiled_below_the_tile_size():
    """An image no larger than encoder_tile_size takes the whole-image VAE:
    the config is taken, and the tiles stay off."""
    p = SuperResolutionPipeline(
        PipelineConfig(no_llava=True, params_dtype="fp32",
                       refine=RefinementConfig(use_tile_vae=True)),
        device="cpu", model_cfgs=TORCH_TINY)
    assert p.cfg.refine.use_tile_vae and not p._use_tiles((512, 1024))
    assert p._use_tiles((513, 1024))
    p.cfg.refine.use_tile_vae = False
    assert not p._use_tiles((2048, 2048))
    assert dataclasses.asdict(p.cfg.refine)["encoder_tile_size"] == 512
