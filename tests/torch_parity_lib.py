"""Shared pieces of the PyTorch-port parity tests: tiny geometries in both
packages' config classes, randomized Flax parameter trees, layout helpers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rsvldm_tpu.models.sdxl.unet import SDXLUNetConfig as JSDXL
from rsvldm_tpu.models.sr3.unet import SR3UNetConfig as JSR3
from rsvldm_tpu.models.text.clip import CLIPTextConfig as JCLIP
from rsvldm_tpu.models.vae.model import VAEConfig as JVAE
from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig as TSDXL
from rsvldm_tpu_torch.models.sr3.unet import SR3UNetConfig as TSR3
from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig as TCLIP
from rsvldm_tpu_torch.models.vae.model import VAEConfig as TVAE

# the JAX pipeline's _tiny_overrides() shapes, in each package's classes
_SR3 = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
            attn_res=(8,), res_blocks=1, image_size=16)
_SDXL = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
             channel_mult=(1, 2), num_head_channels=16,
             transformer_depth=(1, 1), context_dim=64,
             adm_in_channels=32 + 3 * 512)
_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
_CLIP_L = dict(vocab_size=1000, width=32, layers=2, heads=2)
_BIG_G = dict(vocab_size=1000, width=32, layers=2, heads=2, quick_gelu=False,
              use_text_projection=True)

JAX_TINY = dict(sr3=JSR3(**_SR3), sdxl=JSDXL(**_SDXL), vae=JVAE(**_VAE),
                clip_l=JCLIP(**_CLIP_L), big_g=JCLIP(**_BIG_G))
TORCH_TINY = dict(sr3=TSR3(**_SR3), sdxl=TSDXL(**_SDXL), vae=TVAE(**_VAE),
                  clip_l=TCLIP(**_CLIP_L), big_g=TCLIP(**_BIG_G, openclip=True))


def randomize(tree, seed: int):
    """Leaves (arrays or shape structs) drawn from numpy: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1^2), biases and the rest N(0, 0.1^2) scaled for
    embeddings. Zero-initialised convs would otherwise hide whole paths."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel" and x.ndim >= 2:
            fan_in = int(np.prod(x.shape[:-1]))
            v = rng.standard_normal(x.shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def japply(module, tree, *args, method=None):
    """module.apply under jit: one compile beats eager op-by-op dispatch
    several times over at these sizes."""
    return jax.jit(functools.partial(module.apply, method=method))(tree, *args)


def sr3_noise_from_key(key, T, shape):
    """The unit normals JAX sr3_sample draws from `key` without an override:
    [0] = x_T, [1+i] = the noise of loop step i (t = T-1-i)."""
    rng, init_rng = jax.random.split(key)
    draws = [jax.random.normal(init_rng, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(rng, T - 1 - i), shape,
                                jnp.float32) for i in range(T)]
    return np.stack([np.asarray(d) for d in draws])


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, tol: float = 1e-4):
    """max |got - want| <= tol * max(1, max |want|): fp32 on both sides,
    differences come from summation order through deep stacks."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"
