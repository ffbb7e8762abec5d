"""The port's vision towers and projectors held against the JAX package at
tiny width, fp32 on the CPU, with the same seeded Flax trees: every
select_feature mode, act / ffn_width, MLCD's rope2d, open_clip indexing
(and open_clip's checkpoint names mapped by the registry), SigLIP, the
EVA02 and EVA01 geometries (and layer scale with postnorm), the S2 wrapper
(its resize antialiased as jax.image.resize when it shrinks),
build_vision_tower's dispatch and refusals, the projector variants.
(The params_from_jax round trips: tests/test_torch_weights_families.py.)

Tolerance: 1e-4 of max(1, |out|) (torch_parity_lib.assert_close)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.vlm import eva_vit as jeva
from rsvldm_tpu.models.vlm import projector as jproj
from rsvldm_tpu.models.vlm import siglip as jsiglip
from rsvldm_tpu.models.vlm import towers as jtowers
from rsvldm_tpu.models.vlm import vision as jvision
from rsvldm_tpu_torch.models.vlm import eva_vit as teva
from rsvldm_tpu_torch.models.vlm import projector as tproj
from rsvldm_tpu_torch.models.vlm import siglip as tsiglip
from rsvldm_tpu_torch.models.vlm import towers as ttowers
from rsvldm_tpu_torch.models.vlm import vision as tvision
from rsvldm_tpu_torch.utils.checkpoint import load_checked
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import assert_close, japply, randomize, to_np

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _init(jm, shape, seed):
    return to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros(shape)), seed))


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def _px(n=2, side=28):
    return RNG.standard_normal((n, side, side, 3)).astype(np.float32)


# ------------------------------------------------------------ CLIP family
_V = dict(image_size=28, patch_size=14, width=32, layers=12, heads=4)
CLIP_CASES = {
    "patch": dict(select_feature="patch"),
    "cls_patch": dict(select_feature="cls_patch", select_layer=-3),
    "slicefour_patch": dict(select_feature="slicefour_patch", select_layer=-1),
    "slicefour_cls_patch": dict(select_feature="slicefour_cls_patch",
                                select_layer=-2),
    "slice_m25811_f6_patch": dict(select_feature="slice_m25811_f6_patch"),
    "gelu_ffn": dict(act="gelu", ffn_width=48, layers=3),
    "gelu_tanh": dict(act="gelu_tanh", layers=3, select_layer=-1),
    "open_clip": dict(hidden_base="open_clip", select_layer=1, layers=7),
    "open_clip_slicefour": dict(hidden_base="open_clip", layers=8,
                                select_feature="slicefour_patch",
                                select_layer=-1),
    "rope2d": dict(pos_embed="rope2d", act="gelu", ffn_width=40, layers=3),
}


@pytest.mark.parametrize("case", list(CLIP_CASES))
def test_clip_tower_modes_equal_jax(case):
    kw = dict(_V, **CLIP_CASES[case])
    jcfg, tcfg = jvision.CLIPVisionConfig(**kw), tvision.CLIPVisionConfig(**kw)
    jm = jvision.CLIPVisionTower(jcfg)
    tree = _init(jm, (1, 28, 28, 3), 60)
    family = "mlcd" if jcfg.pos_embed == "rope2d" else "clip_vision"
    tm = _load(tvision.CLIPVisionTower(tcfg), params_from_jax(family, tree, tcfg))
    px = _px()
    want = japply(jm, tree, jnp.asarray(px))
    got = tm(torch.from_numpy(px))
    assert got.shape == want.shape
    assert_close(got.numpy(), want)
    assert tvision.slice_indices(tcfg) == jvision._slice_indices(jcfg)


def test_rope2d_tables_equal_jax():
    jcfg = jvision.CLIPVisionConfig(**dict(_V, pos_embed="rope2d"))
    tcfg = tvision.CLIPVisionConfig(**dict(_V, pos_embed="rope2d"))
    row = RNG.standard_normal((1, 4)).astype(np.float32)
    jc, js = jvision._rope2d_angles(jcfg, jnp.asarray(row), 3, 5)
    tc, ts = tvision.rope2d_angles(tcfg, torch.from_numpy(row), 3, 5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_openclip_names_load_through_the_registry_map():
    """An open_clip checkpoint (fused in_proj) made from JAX's tree by
    params_from_jax: the registry's key map loads it into the port's tower,
    which equals JAX."""
    kw = dict(_V, layers=4, hidden_base="open_clip", select_layer=-2)
    jcfg, tcfg = jvision.CLIPVisionConfig(**kw), tvision.CLIPVisionConfig(**kw)
    jm = jvision.CLIPVisionTower(jcfg)
    tree = _init(jm, (1, 28, 28, 3), 61)
    oc = params_from_jax("openclip_vision", tree, tcfg)
    assert "transformer.resblocks.0.attn.in_proj_weight" in oc
    tm = tvision.CLIPVisionTower(tcfg)
    load_checked(tm, ttowers.openclip_to_hf(oc), "open_clip tower")
    px = _px()
    assert_close(tm(torch.from_numpy(px)).detach().numpy(),
                 japply(jm, tree, jnp.asarray(px)))


# ----------------------------------------------------------------- SigLIP
_S = dict(image_size=28, patch_size=14, width=32, layers=3, heads=4, mlp_dim=40)


@pytest.mark.parametrize("select_layer", [-2, -1, 2])
def test_siglip_equal_jax(select_layer):
    kw = dict(_S, select_layer=select_layer)
    jcfg, tcfg = jsiglip.SigLIPVisionConfig(**kw), tsiglip.SigLIPVisionConfig(**kw)
    jm = jsiglip.SigLIPVisionTower(jcfg)
    tree = _init(jm, (1, 28, 28, 3), 64)
    sd = params_from_jax("siglip", tree, tcfg)
    tm = _load(tsiglip.SigLIPVisionTower(tcfg), sd)
    px = _px()
    assert_close(tm(torch.from_numpy(px)).numpy(), japply(jm, tree, jnp.asarray(px)))


# -------------------------------------------------------------------- EVA
_E = dict(image_size=28, patch_size=14, width=32, head_width=8)
EVA_CASES = {
    # tests/test_eva_vit.py's three geometries
    "eva02": dict(layers=4, mlp_ratio=2.5, qkv_bias=True, rope=True,
                  pt_hw_seq_len=2, intp_freq=True, naiveswiglu=True, subln=True),
    "eva01": dict(layers=3, mlp_ratio=4.0, qkv_bias=True, rope=False,
                  naiveswiglu=False, subln=False, intp_freq=False),
    "postnorm_ls": dict(layers=3, mlp_ratio=2.0, qkv_bias=True, rope=False,
                        naiveswiglu=True, subln=True, postnorm=True,
                        ls_init_value=0.1, intp_freq=False),
}


@pytest.mark.parametrize("case", list(EVA_CASES))
@pytest.mark.parametrize("keep_cls", [False, True])
def test_eva_equal_jax(case, keep_cls):
    kw = dict(_E, **EVA_CASES[case])
    jcfg, tcfg = jeva.EvaVitConfig(**kw), teva.EvaVitConfig(**kw)
    jm = jeva.EvaVisionTower(jcfg, keep_cls=keep_cls)
    tree = _init(jm, (1, 28, 28, 3), 65)
    sd = params_from_jax("eva", tree, tcfg)
    tm = _load(teva.EvaVisionTower(tcfg, keep_cls=keep_cls), sd)
    px = _px()
    assert_close(tm(torch.from_numpy(px)).numpy(), japply(jm, tree, jnp.asarray(px)))


def test_eva_rope_tables_equal_jax():
    for key, cfg in teva.EVA_GEOMETRIES.items():
        jcfg = jeva.EVA_GEOMETRIES[key]
        assert dataclasses.asdict(cfg) == {
            k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
        if cfg.rope:
            for a, b in zip(teva._rope_tables(cfg), jeva._rope_tables(jcfg)):
                np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- S2
@pytest.mark.parametrize("side", [28, 40, 20])
def test_s2_equal_jax(side):
    """S2 at scales (28, 56) over the tiny CLIP tower: inputs at the base
    size, above it (the resize shrinks, antialiased) and below it."""
    kw = dict(_V, layers=2)
    jcfg, tcfg = jvision.CLIPVisionConfig(**kw), tvision.CLIPVisionConfig(**kw)
    jm = jvision.CLIPVisionTower(jcfg)
    tree = _init(jm, (1, 28, 28, 3), 66)
    tm = _load(tvision.CLIPVisionTower(tcfg), params_from_jax("clip_vision", tree, tcfg))
    px = _px(2, side)
    want = jvision.s2_multiscale_features(lambda x: jm.apply(tree, x),
                                          jnp.asarray(px), scales=(28, 56))
    got = tvision.s2_multiscale_features(tm, torch.from_numpy(px), scales=(28, 56))
    assert got.shape == (2, 4, 64)
    assert_close(got.numpy(), want)


# -------------------------------------------------------------- registry
@pytest.mark.parametrize("name,width,size,extra", [
    ("openai/clip-vit-large-patch14-336", 1024, 336, {}),
    ("open_clip_hub:ViT-H-14-378-quickgelu", 1280, 378,
     dict(hidden_base="open_clip", act="quick_gelu")),
    ("open_clip_hub:ViT-bigG-14", 1664, 224, dict(ffn_width=8192, act="gelu")),
    ("google/siglip-so400m-patch14-384", 1152, 384, {}),
    ("DeepGlint-AI/mlcd-vit-bigG-patch14-336", 1664, 336,
     dict(pos_embed="rope2d", ffn_width=8192)),
    ("DeepGlint-AI/mlcd-vit-bigG-patch14-448", 1664, 448,
     dict(pos_embed="rope2d")),
    ("EVA02-CLIP-L-14-336", 1024, 336, {}),
    ("Internal-EVA02-CLIP-L-14", 1024, 224, {}),
    ("EVA01-CLIP-g-14", 1408, 224, {}),
])
def test_dispatch_equal_jax(name, width, size, extra):
    """The same family, geometry and knobs as JAX's registry (built here
    without weights: tower_config)."""
    jspec = jtowers.build_vision_tower(name)
    cls, args, _, tsize = ttowers.tower_config(name)
    tcfg = args[0]
    assert tsize == jspec.image_size == size
    assert cls.__name__ == type(jspec.module).__name__
    jcfg = jspec.module.cfg
    assert tcfg.width == jcfg.width == width
    for k, v in extra.items():
        assert getattr(tcfg, k) == getattr(jcfg, k) == v
    want = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    assert dataclasses.asdict(tcfg) == want


def test_dispatch_refusals():
    with pytest.raises(NotImplementedError):
        ttowers.tower_config("imagebind_huge")
    with pytest.raises(ValueError):
        ttowers.tower_config("totally-unknown-tower")
    with pytest.raises(FileNotFoundError):
        ttowers.tower_config("hf:/nonexistent/dir")
    with pytest.raises(ValueError):
        ttowers.tower_config("EVA99-unknown")
    with pytest.raises(ValueError):
        ttowers.tower_config("open_clip_hub:ViT-unknown")


def test_build_hf_tower_from_local_config(tmp_path):
    """`hf:<dir>`: the geometry of the directory's config.json (a nested
    vision_config, gelu_pytorch_tanh), built on the CPU when asked, with
    seeded weights; loading JAX's weights then equals JAX."""
    (tmp_path / "config.json").write_text(json.dumps({"vision_config": dict(
        image_size=28, patch_size=14, hidden_size=32, num_hidden_layers=3,
        num_attention_heads=4, hidden_act="gelu_pytorch_tanh",
        intermediate_size=40)}))
    spec = ttowers.build_vision_tower(f"hf:{tmp_path}", select_layer=-1,
                                      device="cpu")
    jspec = jtowers.build_vision_tower(f"hf:{tmp_path}", select_layer=-1)
    assert spec.image_size == 28 and spec.module.cfg.act == "gelu_tanh"
    assert next(spec.module.parameters()).device.type == "cpu"
    tree = _init(jspec.module, (1, 28, 28, 3), 67)
    sd = params_from_jax("clip_vision", tree, spec.module.cfg)
    load_checked(spec.module, spec.convert(sd), "hf tower")
    px = _px()
    assert_close(spec.module(torch.from_numpy(px)).numpy(),
                 japply(jspec.module, tree, jnp.asarray(px)))
    with pytest.raises(ValueError, match="hidden_act"):
        (tmp_path / "config.json").write_text(json.dumps({"hidden_act": "relu"}))
        ttowers.tower_config(f"hf:{tmp_path}")


# ------------------------------------------------------------ projectors
@pytest.mark.parametrize("kind", ["linear", "mlp2x_gelu", "mlp3x_gelu"])
def test_mlp_projectors_equal_jax(kind):
    jm = jproj.build_projector(kind, out_dim=32)
    x = RNG.standard_normal((2, 4, 24)).astype(np.float32)
    tree = _init(jm, (2, 4, 24), 68)
    sd = params_from_jax("projector", tree, None)
    tm = _load(tproj.build_projector(kind, 24, 32), sd)
    assert_close(tm(torch.from_numpy(x)).numpy(), japply(jm, tree, jnp.asarray(x)))


def test_pooler_projector_equal_jax():
    jm = jproj.build_projector("pooler", out_dim=32, hw=4)
    x = RNG.standard_normal((2, 16, 24)).astype(np.float32)
    tree = _init(jm, (2, 16, 24), 69)
    sd = params_from_jax("pooler_projector", tree, None)
    tm = _load(tproj.build_projector("pooler", 24, 32, hw=4), sd)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 4, 32)
    assert_close(got.numpy(), japply(jm, tree, jnp.asarray(x)))


def test_identity_projector_and_unknown():
    x = torch.randn(1, 3, 8)
    assert torch.equal(tproj.build_projector("identity")(x), x)
    with pytest.raises(ValueError):
        tproj.build_projector("mlp_relu")
