"""The port's seeded weights held against the JAX package's, from the seed
alone: prng.truncated_normal against jax.random.truncated_normal, flax_key
against the keys Flax hands its initialisers, jax_leaves against
jax.eval_shape of the full-width trees, smoke_init against the JAX
pipeline's bf16 rule (_init_params) and flax_init against Flax's
Module.init, for the pipeline's six families at the tiny geometries, the
trainer's SR3, the smoke decoder and the smoke projector; and
params_from_jax on torch leaves (device and dtype kept)."""

import functools
import types
import zlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.sdxl.control import ControlledUNet, GLVControl
from rsvldm_tpu.models.sdxl.unet import SDXLUNetConfig as JSDXL
from rsvldm_tpu.models.sr3.unet import SR3UNet, SR3UNetConfig as JSR3
from rsvldm_tpu.models.text.clip import (CLIP_L_CONFIG as JCLIP_L,
                                         CLIPTextTransformer,
                                         OPENCLIP_BIGG_CONFIG as JBIGG)
from rsvldm_tpu.models.vae.model import SDXL_VAE_CONFIG as JVAE, AutoencoderKL
from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.projector import MLPProjector as JProjector
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig
from rsvldm_tpu_torch.models.text.clip import (CLIP_L_CONFIG,
                                               OPENCLIP_BIGG_CONFIG)
from rsvldm_tpu_torch.models.vae.model import SDXL_VAE_CONFIG
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.train_sr3 import TINY_SR3
from rsvldm_tpu_torch.utils import prng
from rsvldm_tpu_torch.utils.jax_init import (flax_init, flax_key, jax_leaves,
                                             smoke_init)
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import JAX_TINY, TORCH_TINY, to_np

torch.set_num_threads(1)
TN_TOL = 1e-6  # XLA's log1p in erf_inv is not torch's (tests/test_torch_prng.py)
SMOKE = dict(vocab_size=512, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
PIPE_FAMILIES = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
TCFG = {"sr3": TORCH_TINY["sr3"], "unet": TORCH_TINY["sdxl"],
        "control": TORCH_TINY["sdxl"], "vae": TORCH_TINY["vae"],
        "clip_l": TORCH_TINY["clip_l"], "big_g": TORCH_TINY["big_g"]}


def _close(got: torch.Tensor, want, tol: float = TN_TOL):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"max scaled err {err.max()}"


# ------------------------------------------------------ truncated normal
@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0), (0.3, 1.7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 11])
def test_truncated_normal_equals_jax(bounds, dtype, seed):
    """jax.random.truncated_normal's numbers from the same key: bf16 bit for
    bit, fp32 within 1e-6 relative, every draw inside the open bounds."""
    lo, hi = bounds
    want = jax.random.truncated_normal(jax.random.PRNGKey(seed), lo, hi,
                                       (3, 1031), getattr(jnp, dtype))
    got = prng.truncated_normal(prng.key(seed), lo, hi, (3, 1031),
                                getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    assert float(got.min()) > lo and float(got.max()) < hi


def test_truncated_normal_rows_as_draw():
    """draw(rows, shape, "truncated_normal", minval=lo, maxval=hi): row r
    from fold_in(key, step_r), as jax.random.truncated_normal of that key."""
    k = prng.key(5)
    got = prng.draw([(k, 3), (k, None)], (257,), "truncated_normal",
                    minval=-2.0, maxval=2.0)
    jk = jax.random.PRNGKey(5)
    _close(got[0], jax.random.truncated_normal(jax.random.fold_in(jk, 3), -2,
                                               2, (257,)))
    _close(got[1], jax.random.truncated_normal(jk, -2, 2, (257,)))


# ---------------------------------------------------------- Flax's keys
class _Inner(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Dense(3, kernel_init=_REC.init("k"), bias_init=_REC.init("b"))(x)
        self.param("zeros_first", nn.initializers.zeros, (2,))
        self.param("own", _REC.init("own"), (2,))
        return nn.Dense(2, kernel_init=_REC.init("k2"), name="proj")(x)


class _Outer(nn.Module):
    @nn.compact
    def __call__(self, x):
        self.param("ones_first", nn.initializers.ones, (1,))
        self.param("top", _REC.init("top"), (4,))
        x = _Inner(name="block_10")(x)
        x = _Inner()(x)  # auto-named _Inner_0
        return nn.LayerNorm(scale_init=_REC.init("s"))(x)


class _Recorder:
    """Initialisers that record the key Flax hands them."""

    def __init__(self):
        self.keys = []

    def init(self, tag):
        def fn(key, shape, dtype=jnp.float32):
            self.keys.append((tag, tuple(int(v) for v in np.asarray(key))))
            return jnp.zeros(shape, dtype)
        return fn


_REC = _Recorder()


def test_flax_key_equals_flax():
    """The keys Flax's make_rng gives named and auto-named parameters:
    fold_in of the SHA-1 of the scope's names and the scope's count of
    `self.param` calls (zeros and ones included)."""
    _REC.keys.clear()
    _Outer().init(jax.random.PRNGKey(3), jnp.zeros((1, 5)))
    k = prng.key(3)
    want = [("top", (), 2)]
    for scope in (("block_10",), ("_Inner_0",)):
        want += [("k", scope + ("Dense_0",), 1), ("b", scope + ("Dense_0",), 2),
                 ("own", scope, 2), ("k2", scope + ("proj",), 1)]
    want.append(("s", ("LayerNorm_0",), 1))
    assert len(_REC.keys) == len(want)
    for (tag, got), (wtag, scope, counter) in zip(_REC.keys, want):
        assert tag == wtag
        assert got == flax_key(k, scope, counter), (tag, scope)


# ------------------------------------------------------ trees and order
@functools.lru_cache(maxsize=None)
def _jax_inits():
    """(family, JAX init fn of a key, port cfg) at the full-width defaults
    and a smoke Llama of 11 layers (layer_10 sorts before layer_2)."""
    ucfg = JSDXL()
    lat, tt = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 7, ucfg.context_dim))
    yv = jnp.zeros((1, ucfg.adm_in_channels))
    ctl = GLVControl(ucfg)
    shapes = jax.eval_shape(lambda k: ctl.init(k, lat, lat, tt, ctx, yv),
                            jax.random.PRNGKey(0))
    feats = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: ctl.apply(p, lat, lat, tt, ctx, yv), shapes))
    toks = jnp.zeros((1, 77), jnp.int32)
    jl = JLlamaConfig(**dict(SMOKE, layers=11))
    lm = JLlama(jl)
    return {
        "sr3": (lambda k: SR3UNet(JSR3()).init(
            k, jnp.zeros((1, 224, 224, 6)), jnp.ones((1, 1))), SR3UNetConfig()),
        "control": (lambda k: ctl.init(k, lat, lat, tt, ctx, yv),
                    SDXLUNetConfig()),
        "unet": (lambda k: ControlledUNet(ucfg).init(k, lat, tt, ctx, yv,
                                                     feats), SDXLUNetConfig()),
        "vae": (lambda k: AutoencoderKL(JVAE).init(k, jnp.zeros((1, 32, 32, 3))),
                SDXL_VAE_CONFIG),
        "clip_l": (lambda k: CLIPTextTransformer(JCLIP_L).init(k, toks),
                   CLIP_L_CONFIG),
        "big_g": (lambda k: CLIPTextTransformer(JBIGG).init(k, toks),
                  OPENCLIP_BIGG_CONFIG),
        "llama": (lambda k: lm.init(k, jnp.zeros((1, 4), jnp.int32),
                                    JKVCache.init(jl, 1, 8), 0,
                                    method=lm.from_tokens),
                  LlamaConfig(**dict(SMOKE, layers=11))),
        "projector": (lambda k: JProjector(out_dim=4096).init(
            k, jnp.zeros((1, 4, 1024))), (1024, 4096)),
    }


@pytest.mark.parametrize("family", ["sr3", "unet", "control", "vae", "clip_l",
                                    "big_g", "llama", "projector"])
def test_jax_leaves_equal_eval_shape(family):
    """Every leaf of the full-width tree (abstract) in path, shape, dtype
    and flatten order."""
    fn, cfg = _jax_inits()[family]
    flat = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(fn, jax.random.PRNGKey(0)))[0]
    want = [(tuple(str(getattr(k, "key", k)) for k in path[1:]),
             tuple(s.shape), str(s.dtype)) for path, s in flat]
    assert all(str(path[0].key) == "params" for path, _ in flat)
    got = [(p, s, str(d).replace("torch.", ""))
           for p, s, d in jax_leaves(family, cfg)]
    assert got == want


# ------------------------------------------------------- the two inits
@functools.lru_cache(maxsize=None)
def _jax_tiny_inits():
    """The JAX pipeline's init fns at the tiny geometries
    (rsvldm_tpu/pipeline.py:206-290), keyed by family."""
    sc, uc = JAX_TINY["sr3"], JAX_TINY["sdxl"]
    lat, tt = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 7, uc.context_dim))
    yv = jnp.zeros((1, uc.adm_in_channels))
    ctl = GLVControl(uc)
    shapes = jax.eval_shape(lambda k: ctl.init(k, lat, lat, tt, ctx, yv),
                            jax.random.PRNGKey(0))
    feats = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: ctl.apply(p, lat, lat, tt, ctx, yv), shapes))
    toks = jnp.zeros((1, 77), jnp.int32)
    return {
        "sr3": lambda k: SR3UNet(sc).init(
            k, jnp.zeros((1, sc.image_size, sc.image_size, 6)), jnp.ones((1, 1))),
        "control": lambda k: ctl.init(k, lat, lat, tt, ctx, yv),
        "unet": lambda k: ControlledUNet(uc).init(k, lat, tt, ctx, yv, feats),
        "vae": lambda k: AutoencoderKL(JAX_TINY["vae"]).init(
            k, jnp.zeros((1, 32, 32, 3))),
        "clip_l": lambda k: CLIPTextTransformer(JAX_TINY["clip_l"]).init(k, toks),
        "big_g": lambda k: CLIPTextTransformer(JAX_TINY["big_g"]).init(k, toks),
    }


def _sd_equal(got, want, exact_keys=()):
    """Every tensor of `want` in `got`, the same shape and dtype; draws
    within TN_TOL, zeros and ones exact."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if bool((w == 0).all()) or bool((w == 1).all()):
            assert torch.equal(g, w), k
        else:
            _close(g, w.float())


@functools.lru_cache(maxsize=None)
def _jax_smoke_tree(family):
    """JAX's _init_params at params_dtype bf16 (numpy bf16 leaves)."""
    fake = types.SimpleNamespace(
        cfg=types.SimpleNamespace(params_dtype="bf16", ckpt_dir="none"),
        debug_tiny=False)
    return to_np(JPipeline._init_params(fake, family,
                                        _jax_tiny_inits()[family]))


@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_smoke_init_equals_jax_pipeline(family):
    """The bf16 rule of the JAX pipeline's _init_params at params_dtype bf16
    (crc32 key, fold_in(key, i) per leaf) through params_from_jax: the
    port's smoke_init, bf16 on the CPU, zeros and ones exact, the draws as
    tests/test_torch_prng.py holds bf16 normals."""
    tree = jax.tree_util.tree_map(lambda x: torch.from_numpy(
        np.array(x, np.float32)).to(torch.bfloat16), _jax_smoke_tree(family))
    want = params_from_jax(family, tree, TCFG[family])
    got = smoke_init(family, TCFG[family])
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    _sd_equal(got, want)


@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_flax_init_equals_jax_init(family):
    """Flax's init from PRNGKey(crc32(family) % 2^31), the JAX pipeline's
    fp32 path: truncated normals within 1e-6, the rest exact."""
    seed = zlib.crc32(family.encode()) % (2 ** 31)
    tree = to_np(jax.jit(_jax_tiny_inits()[family])(jax.random.PRNGKey(seed)))
    want = params_from_jax(family, tree, TCFG[family])
    got = flax_init(family, TCFG[family])
    assert all(v.dtype == torch.float32 for v in got.values())
    _sd_equal(got, want)


def test_flax_init_sr3_trainer_and_smoke_models():
    """The SR3 trainer's init (its tiny geometry, PRNGKey(3)), the smoke
    decoder (PRNGKey(0) through from_tokens) and the smoke projector
    (PRNGKey(7), 8 -> 32) as Flax's init gives them."""
    jsr3 = JSR3(**{k: v for k, v in vars(SR3UNetConfig(**TINY_SR3)).items()})
    tree = to_np(jax.jit(lambda k: SR3UNet(jsr3).init(
        k, jnp.zeros((1, jsr3.image_size, jsr3.image_size, 6)),
        jnp.ones((1, 1))))(jax.random.PRNGKey(3)))
    _sd_equal(flax_init("sr3", SR3UNetConfig(**TINY_SR3), prng.key(3)),
              params_from_jax("sr3", tree, SR3UNetConfig(**TINY_SR3)))
    jl = JLlamaConfig(**SMOKE, dtype=jnp.float32)
    lm = JLlama(jl)
    tree = to_np(jax.jit(lambda k: lm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(jl, 1, 8), 0,
        method=lm.from_tokens))(jax.random.PRNGKey(0)))
    _sd_equal(flax_init("llama", LlamaConfig(**SMOKE), prng.key(0)),
              params_from_jax("llama", tree, LlamaConfig(**SMOKE)))
    tree = to_np(JProjector(out_dim=32, dtype=jnp.float32).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 4, 8))))
    _sd_equal(flax_init("projector", (8, 32), prng.key(7)),
              params_from_jax("projector", tree, None))


# ------------------------------------------- params_from_jax on tensors
@pytest.mark.parametrize("family", PIPE_FAMILIES)
def test_params_from_jax_keeps_device_and_dtype(family):
    """Torch leaves keep their dtype and device (bf16 leaves unchanged, the
    layout moves exact permutes), the same values as numpy leaves give;
    meta leaves stay meta."""
    tree = _jax_smoke_tree(family)
    t16 = jax.tree_util.tree_map(lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(torch.bfloat16), tree)
    got = params_from_jax(family, t16, TCFG[family])
    ref = params_from_jax(family, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), tree), TCFG[family])
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16 and v.device.type == "cpu"
        assert torch.equal(v.float(), ref[k]), k
    meta = params_from_jax(family, jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), tree), TCFG[family])
    assert all(v.device.type == "meta" and v.shape == ref[k].shape
               for k, v in meta.items())
