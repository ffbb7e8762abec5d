"""params_from_jax for the families of the other decoders, towers,
projectors, resamplers and T5: a seeded Flax tree (tiny width) ->
params_from_jax -> the JAX package's own converter gives the tree back
bit for bit, so the port's state dicts carry the reference checkpoints'
names and layouts (Qwen2's q/k/v biases, Gemma's tied head, MoE in
Mixtral's and in Qwen2-MoE's expert names, open_clip's fused in_proj,
EVA's q/v biases and sub-LNs, the Q-Former's BERT names, ...)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsvldm_tpu.models.text import t5 as jt5
from rsvldm_tpu.models.vlm import eva_vit as jeva
from rsvldm_tpu.models.vlm import llama as jllama
from rsvldm_tpu.models.vlm import mpt as jmpt
from rsvldm_tpu.models.vlm import projector as jproj
from rsvldm_tpu.models.vlm import resampler as jres
from rsvldm_tpu.models.vlm import siglip as jsiglip
from rsvldm_tpu.models.vlm import vision as jvision
from rsvldm_tpu.utils import convert_hf
from rsvldm_tpu_torch.models.text import t5 as tt5
from rsvldm_tpu_torch.models.vlm import eva_vit as teva
from rsvldm_tpu_torch.models.vlm import llama as tllama
from rsvldm_tpu_torch.models.vlm import mpt as tmpt
from rsvldm_tpu_torch.models.vlm import resampler as tres
from rsvldm_tpu_torch.models.vlm import siglip as tsiglip
from rsvldm_tpu_torch.models.vlm import vision as tvision
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import randomize, to_np

_L = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
_LLAMA = {
    "qwen2_biases": dict(attn_bias=True),
    "gemma_tied_head": dict(norm_plus_one=True, scale_embeds=True,
                            tie_lm_head=True, act="gelu_tanh", head_dim_cfg=16),
    "mixtral_layout": dict(num_experts=4, experts_per_tok=2),
    "qwen2_moe_layout": dict(attn_bias=True, num_experts=4, moe_ffn_dim=24,
                             shared_expert_dim=40, norm_topk_prob=False),
}
_V = dict(image_size=28, patch_size=14, width=32, layers=3, heads=4)
_E = dict(image_size=28, patch_size=14, width=32, head_width=8, layers=3)
PX = (1, 28, 28, 3)


def _llama(kw):
    jcfg, tcfg = jllama.LlamaConfig(**_L, **kw), tllama.LlamaConfig(**_L, **kw)
    jm = jllama.LlamaModel(jcfg)
    init = lambda k: jm.init(k, jnp.zeros((1, 4), jnp.int32),
                             jllama.KVCache.init(jcfg, 1, 8), 0,
                             method=jm.from_tokens)
    return init, "llama", tcfg, lambda sd: convert_hf.convert_llama(sd, jcfg)


def _mpt():
    kw = dict(vocab_size=64, dim=32, layers=2, heads=4)
    jcfg, tcfg = jmpt.MPTConfig(**kw), tmpt.MPTConfig(**kw)
    jm = jmpt.MPTModel(jcfg)
    init = lambda k: jm.init(k, jnp.zeros((1, 4), jnp.int32),
                             jmpt.MPTKVCache.init(jcfg, 1, 8), 0,
                             method=jm.from_tokens)
    return init, "mpt", tcfg, lambda sd: convert_hf.convert_mpt(sd, jcfg)


def _clip(family, converter, **kw):
    jcfg = jvision.CLIPVisionConfig(**_V, **kw)
    tcfg = tvision.CLIPVisionConfig(**_V, **kw)
    jm = jvision.CLIPVisionTower(jcfg)
    return (lambda k: jm.init(k, jnp.zeros(PX)), family, tcfg,
            lambda sd: converter(sd, jcfg))


def _siglip():
    kw = dict(_V, mlp_dim=40)
    jcfg, tcfg = jsiglip.SigLIPVisionConfig(**kw), tsiglip.SigLIPVisionConfig(**kw)
    jm = jsiglip.SigLIPVisionTower(jcfg)
    return (lambda k: jm.init(k, jnp.zeros(PX)), "siglip", tcfg,
            lambda sd: jsiglip.convert_hf_siglip_vision(sd, jcfg))


def _eva(**kw):
    jcfg, tcfg = jeva.EvaVitConfig(**_E, **kw), teva.EvaVitConfig(**_E, **kw)
    jm = jeva.EvaVisionTower(jcfg)
    return (lambda k: jm.init(k, jnp.zeros(PX)), "eva", tcfg,
            lambda sd: convert_hf.convert_eva_vision(sd, jcfg))


def _t5(gated):
    kw = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=40, layers=2, heads=4,
              gated_ff=gated)
    jcfg, tcfg = jt5.T5Config(**kw), tt5.T5Config(**kw)
    jm = jt5.T5Encoder(jcfg)
    return (lambda k: jm.init(k, jnp.zeros((1, 8), jnp.int32)), "t5", tcfg,
            lambda sd: convert_hf.convert_t5_encoder(sd, jcfg))


def _qformer():
    kw = dict(hidden_size=32, layers=3, heads=4, intermediate=48,
              encoder_width=24, num_latents=8, cross_attention_freq=2)
    jcfg, tcfg = jres.QFormerConfig(**kw), tres.QFormerConfig(**kw)
    jm = jres.QFormerResampler(jcfg)
    return (lambda k: jm.init(k, jnp.zeros((1, 6, 24))), "qformer", tcfg,
            lambda sd: convert_hf.convert_qformer(sd, jcfg))


def _perceiver(ff_mult):
    kw = dict(dim=24, depth=2, dim_head=4, heads=4, num_latents=8,
              ff_mult=ff_mult)
    jcfg, tcfg = jres.PerceiverConfig(**kw), tres.PerceiverConfig(**kw)
    jm = jres.PerceiverResampler(jcfg)
    return (lambda k: jm.init(k, jnp.zeros((1, 6, 24))), "perceiver", tcfg,
            lambda sd: convert_hf.convert_perceiver(sd, jcfg))


def _projector(kind, **kw):
    jm = jproj.build_projector(kind, out_dim=32, **kw)
    x = jnp.zeros((1, 16, 24))
    if kind == "pooler":
        return (lambda k: jm.init(k, x), "pooler_projector", None,
                lambda sd: convert_hf.convert_pooler_projector(
                    {f"p.{n}": v for n, v in sd.items()}, prefix="p"))
    return (lambda k: jm.init(k, x), "projector", None,
            lambda sd: convert_hf.convert_mm_projector(
                {f"p.{n}": v for n, v in sd.items()}, prefix="p"))


CASES = {
    **{f"llama_{k}": (lambda kw=kw: _llama(kw)) for k, kw in _LLAMA.items()},
    "mpt": _mpt,
    "clip_vision_gelu_ffn": lambda: _clip(
        "clip_vision", convert_hf.convert_hf_clip_vision, act="gelu",
        ffn_width=40),
    "mlcd": lambda: _clip("mlcd", convert_hf.convert_mlcd_vision,
                          pos_embed="rope2d", act="gelu"),
    "openclip_vision": lambda: _clip(
        "openclip_vision", convert_hf.convert_openclip_vision,
        hidden_base="open_clip"),
    "siglip": _siglip,
    "eva02": lambda: _eva(rope=True, pt_hw_seq_len=2, naiveswiglu=True,
                          subln=True),
    "eva01": lambda: _eva(rope=False, naiveswiglu=False, subln=False,
                          intp_freq=False, mlp_ratio=4.0),
    "eva_postnorm_layer_scale": lambda: _eva(rope=False, postnorm=True,
                                             ls_init_value=0.1,
                                             intp_freq=False),
    "t5_gated": lambda: _t5(True),
    "t5_relu": lambda: _t5(False),
    "qformer": _qformer,
    "perceiver": lambda: _perceiver(2),
    "perceiver_no_ff": lambda: _perceiver(0),
    "pooler_projector": lambda: _projector("pooler", hw=4),
    "projector_mlp2x": lambda: _projector("mlp2x_gelu"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_equals_jax_converter(case):
    init, family, cfg, convert = CASES[case]()
    tree = to_np(randomize(jax.eval_shape(init, jax.random.PRNGKey(0)),
                           sum(map(ord, case))))
    got = convert(params_from_jax(family, tree, cfg))
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(p))


def test_mlp_projector_of_any_depth_names():
    """mlpNx_gelu's layers are the reference Sequential's 0, 2, 4, ... (JAX's
    converter reads only depth 2); `linear` is one bare Linear."""
    rng = np.random.default_rng(0)
    dense = lambda i, o: {"kernel": rng.standard_normal((i, o), np.float32),
                          "bias": rng.standard_normal(o, np.float32)}
    tree = {"fc0": dense(24, 32), "fc1": dense(32, 32), "fc2": dense(32, 32)}
    sd = params_from_jax("projector", tree, None)
    assert sorted(sd) == ["0.bias", "0.weight", "2.bias", "2.weight",
                          "4.bias", "4.weight"]
    np.testing.assert_array_equal(sd["4.weight"].numpy(), tree["fc2"]["kernel"].T)
    sd = params_from_jax("projector", {"fc0": tree["fc0"]}, None)
    assert sorted(sd) == ["bias", "weight"]
