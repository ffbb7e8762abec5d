"""The port's other decoder families held against the JAX package at tiny
geometry, fp32 on the CPU: Qwen2 (q/k/v biases), Mistral (a sliding window
of 8, shorter than the prompts), Gemma ((1 + w) norms, tanh GELU, the
embedding scale, the tied head, 16-wide heads that are not dim // heads),
Mixtral and Qwen2-MoE with its shared expert (MoEFFN), on fp32 and, where
JAX allows it, int8 and int4 bases: prefill logits, decode steps fed their
greedy tokens, the KV caches and a 16-token greedy caption; MPT (ALiBi,
its own cache) prefill and decode; the captioner with Gemma's tied head.
(The params_from_jax round trips: tests/test_torch_weights_families.py.)

Tolerance: 1e-4 of max(1, |logits|) (torch_parity_lib.assert_close); fp32
on both sides, the differences are summation order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.models.vlm import generate as jgen
from rsvldm_tpu.models.vlm import llama as jllama
from rsvldm_tpu.models.vlm import mpt as jmpt
from rsvldm_tpu.models.vlm.captioner import LlavaCaptioner as JCaptioner
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
from rsvldm_tpu.models.vlm.vision import CLIPVisionTower as JTower
from rsvldm_tpu_torch.config import LlavaConfig
from rsvldm_tpu_torch.models.vlm import generate as tgen
from rsvldm_tpu_torch.models.vlm import llama as tllama
from rsvldm_tpu_torch.models.vlm import mpt as tmpt
from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
from rsvldm_tpu_torch.utils.weights import llava_from_jax, params_from_jax
from torch_parity_lib import assert_close, randomize, to_np

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
_BASE = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
FAMILIES = {
    "qwen2": dict(attn_bias=True, rope_theta=1e6, rms_eps=1e-6),
    "mistral": dict(sliding_window=8, rope_theta=1e4),
    "gemma": dict(norm_plus_one=True, scale_embeds=True, tie_lm_head=True,
                  act="gelu_tanh", head_dim_cfg=16, kv_heads=4, rms_eps=1e-6),
    "mixtral": dict(num_experts=4, experts_per_tok=2),
    "qwen2_moe": dict(attn_bias=True, num_experts=4, experts_per_tok=2,
                      moe_ffn_dim=24, norm_topk_prob=False,
                      shared_expert_dim=40),
}


def _cfgs(family):
    kw = dict(_BASE, **FAMILIES[family])
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


_TREES: dict = {}  # the seeded trees, one per family


def _tree(family):
    if family not in _TREES:
        jcfg, _ = _cfgs(family)
        jm = jllama.LlamaModel(jcfg)
        shapes = jax.eval_shape(lambda k: jm.init(
            k, jnp.zeros((1, 4), jnp.int32), jllama.KVCache.init(jcfg, 1, 8), 0,
            method=jm.from_tokens), jax.random.PRNGKey(0))
        tree = to_np(randomize(shapes, 40 + len(_TREES)))
        if jcfg.norm_plus_one:  # (1 + w) norms: w near 0, as Gemma's are
            tree = jax.tree_util.tree_map_with_path(
                lambda p, x: x - 1.0 if "norm" in jax.tree_util.keystr(p) else x,
                tree)
        _TREES[family] = tree
    return _TREES[family]


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


def _models(family, mode):
    """(JAX module, JAX params, port module, port cfg) on a `mode` base."""
    jcfg, tcfg = _cfgs(family)
    tree = _tree(family)
    port = _load(tllama.LlamaModel(tcfg), params_from_jax("llama", tree, tcfg))
    if mode is None:
        return jllama.LlamaModel(jcfg), tree, port, tcfg
    qtree = {"params": jllama.quantize_llama_params(
        tree["params"], embed_dtype=jnp.bfloat16, mode=mode)}
    return (jllama.LlamaModel(dataclasses.replace(jcfg, quant=mode)), qtree,
            tllama.quantize_llama_(port, mode), tcfg)


CASES = [(f, None) for f in FAMILIES] + [
    (f, m) for f in ("qwen2", "mistral", "gemma") for m in ("int8", "int4")]


@pytest.mark.parametrize("family,mode", CASES)
def test_prefill_and_decode_equal_jax(family, mode):
    """A 12-token prefill from position 0 (longer than Mistral's window),
    then 4 decode steps fed their greedy tokens: logits at every step and
    the caches."""
    jm, jp, tm, tcfg = _models(family, mode)
    jcfg = jm.cfg
    prefill = jax.jit(lambda p, t, c: jm.apply(p, t, c, 0, method=jm.from_tokens))
    decode = jax.jit(lambda p, t, c, pos: jm.apply(p, t, c, pos,
                                                   method=jm.from_tokens))
    toks = RNG.integers(0, 256, (1, 12)).astype(np.int32)
    jc, tc = jllama.KVCache.init(jcfg, 1, 20), tllama.KVCache.init(tcfg, 1, 20)
    jl, jc = prefill(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        tl, tc = tm(tm.embed(torch.from_numpy(toks).long()), tc, 0)
        assert_close(tl.numpy(), jl)
        pos = toks.shape[1]
        for _ in range(4):
            tok = np.asarray(jnp.argmax(jl[0, -1])).astype(np.int32).reshape(1, 1)
            jl, jc = decode(jp, jnp.asarray(tok), jc, pos)
            tl, tc = tm(tm.embed(torch.from_numpy(tok).long()), tc,
                        torch.tensor(pos))
            assert_close(tl.numpy(), jl)
            pos += 1
    assert_close(tc.k.numpy(), jc.k)
    assert_close(tc.v.numpy(), jc.v)


@pytest.mark.parametrize("family,mode", [(f, None) for f in FAMILIES]
                         + [("gemma", "int4"), ("qwen2", "int4")])
def test_greedy_caption_ids_equal_jax(family, mode):
    """16 greedy tokens from a 10-row prompt (padded to 16: Mistral's
    window then runs past the prompt)."""
    jm, jp, tm, tcfg = _models(family, mode)
    embeds = (RNG.standard_normal((10, 32)) * 0.5).astype(np.float32)
    kw = dict(max_new_tokens=16, do_sample=False, pad_to=16)
    want = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(**kw),
                         jax.random.PRNGKey(0))
    got = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(**kw))
    np.testing.assert_array_equal(got, want)
    assert len(got) == 16


def test_mistral_window_masks_old_keys():
    """The window changes the logits (the same weights without it give
    others), and a windowed prefill never reaches the attention dispatcher
    that leads to K1."""
    _, tree, tm, tcfg = _models("mistral", None)
    full = _load(tllama.LlamaModel(dataclasses.replace(tcfg, sliding_window=None)),
                 params_from_jax("llama", tree, tcfg))
    toks = torch.from_numpy(RNG.integers(0, 256, (1, 12))).long()
    calls = []
    orig = tllama.attention
    tllama.attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.inference_mode():
            win, _ = tm(tm.embed(toks), tllama.KVCache.init(tcfg, 1, 12), 0)
            assert not calls
            ref, _ = full(full.embed(toks), None, 0)
            assert calls
    finally:
        tllama.attention = orig
    assert_close(win[:, :8].numpy(), ref[:, :8].numpy())
    assert float((win[:, 8:] - ref[:, 8:]).abs().max()) > 1e-3


def test_windowed_prefill_without_cache_equals_cached():
    _, _, tm, tcfg = _models("mistral", None)
    toks = torch.from_numpy(RNG.integers(0, 256, (2, 12))).long()
    with torch.inference_mode():
        a, _ = tm(tm.embed(toks), None, 0)
        b, _ = tm(tm.embed(toks), tllama.KVCache.init(tcfg, 2, 16), 0)
    assert_close(a.numpy(), b.numpy(), 1e-6)


def test_gemma_embedding_scale_rounds_like_jax():
    """sqrt(3072) = 55.43 is rounded to the activation dtype before the
    product: 55.5 in bf16, as JAX's astype does."""
    cfg = tllama.LlamaConfig(vocab_size=8, dim=3072, layers=0, heads=16,
                             kv_heads=16, ffn_dim=8, scale_embeds=True,
                             head_dim_cfg=256)
    m = tllama.LlamaModel(cfg).to(torch.bfloat16)
    with torch.no_grad():
        m.model.embed_tokens.weight.fill_(1.0)
    with torch.no_grad():
        got = m.embed(torch.zeros(1, 1, dtype=torch.long))
    want = np.asarray(jnp.ones((), jnp.bfloat16)
                      * jnp.sqrt(jnp.float32(3072)).astype(jnp.bfloat16))
    assert float(got[0, 0, 0]) == float(want) == 55.5


def test_moe_router_has_no_ties():
    """The seeded routers' top-k never ties (jax.lax.top_k and torch.topk
    may order ties differently): the gaps at the k-th place are wide."""
    for family in ("mixtral", "qwen2_moe"):
        _, tree, tm, tcfg = _models(family, None)
        toks = torch.from_numpy(RNG.integers(0, 256, (1, 12))).long()
        h = tm.embed(toks)
        moe = getattr(tm.model.layers[0], tm.model.layers[0].ffn_name)
        probs = torch.softmax(moe.gate(h).float(), -1)
        top = probs.topk(tcfg.experts_per_tok + 1, -1).values
        assert float((top[..., -2] - top[..., -1]).min()) > 1e-5


def test_moe_state_dict_names_are_the_references():
    for family, prefix, names in (
            ("mixtral", "model.layers.1.block_sparse_moe", ("w1", "w2", "w3")),
            ("qwen2_moe", "model.layers.1.mlp",
             ("gate_proj", "up_proj", "down_proj"))):
        _, tree, tm, tcfg = _models(family, None)
        sd = tm.state_dict()
        assert f"{prefix}.gate.weight" in sd
        for e in range(4):
            for n in names:
                assert f"{prefix}.experts.{e}.{n}.weight" in sd
        assert not any("experts_" in k for k in sd)
        assert (f"{prefix}.shared_expert_gate.weight" in sd) == (family == "qwen2_moe")
    # a Mixtral block loads a state dict in Qwen2-MoE's expert names too
    moe = _models("mixtral", None)[2].model.layers[1].block_sparse_moe
    renamed = {k.replace(".w1.", ".gate_proj.").replace(".w3.", ".up_proj.")
               .replace(".w2.", ".down_proj."): v
               for k, v in moe.state_dict().items()}
    fresh = tllama.MoEFFN(_cfgs("mixtral")[1])
    fresh.load_state_dict(renamed, strict=True)
    for n in ("experts_gate", "experts_up", "experts_down"):
        torch.testing.assert_close(getattr(fresh, n), getattr(moe, n),
                                   rtol=0, atol=0)


def test_moe_refuses_quantization():
    _, _, tm, _ = _models("mixtral", None)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.quantize_llama_(tm, "int8")


def test_quantized_biases_kept():
    jm, jp, tm, _ = _models("qwen2", "int4")
    sd = tm.state_dict()
    np.testing.assert_array_equal(
        sd["model.layers.0.self_attn.q_proj.bias"].numpy(),
        np.asarray(jp["params"]["layer_0"]["q_proj"]["bias"]))
    assert sd["model.layers.0.self_attn.q_proj.bias"].dtype == torch.float32


# -------------------------------------------------------------------- MPT
_MPT = dict(vocab_size=128, dim=32, layers=2, heads=4)


@pytest.fixture(scope="module")
def mpt_pair():
    jcfg, tcfg = jmpt.MPTConfig(**_MPT), tmpt.MPTConfig(**_MPT)
    jm = jmpt.MPTModel(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), jmpt.MPTKVCache.init(jcfg, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    tree = to_np(randomize(shapes, 50))
    tm = _load(tmpt.MPTModel(tcfg), params_from_jax("mpt", tree, tcfg))
    return jm, tree, tm, jcfg, tcfg


def test_mpt_prefill_and_decode_equal_jax(mpt_pair):
    jm, tree, tm, jcfg, tcfg = mpt_pair
    prefill = jax.jit(lambda p, t, c: jm.apply(p, t, c, 0, method=jm.from_tokens))
    decode = jax.jit(lambda p, t, c, pos: jm.apply(p, t, c, pos,
                                                   method=jm.from_tokens))
    toks = RNG.integers(0, 128, (1, 9)).astype(np.int32)
    jc, tc = jmpt.MPTKVCache.init(jcfg, 1, 16), tmpt.MPTKVCache.init(tcfg, 1, 16)
    jl, jc = prefill(tree, jnp.asarray(toks), jc)
    with torch.inference_mode():
        tl, tc = tm(tm.embed(torch.from_numpy(toks).long()), tc, 0)
        assert_close(tl.numpy(), jl)
        pos = toks.shape[1]
        for _ in range(4):
            tok = np.asarray(jnp.argmax(jl[0, -1])).astype(np.int32).reshape(1, 1)
            jl, jc = decode(tree, jnp.asarray(tok), jc, pos)
            tl, tc = tm(tm.embed(torch.from_numpy(tok).long()), tc,
                        torch.tensor(pos))
            assert_close(tl.numpy(), jl)
            pos += 1
    assert_close(tc.k.numpy(), jc.k)
    assert_close(tc.v.numpy(), jc.v)


@pytest.mark.parametrize("heads", [4, 6, 12])
def test_alibi_slopes_equal_jax(heads):
    np.testing.assert_array_equal(tmpt.alibi_slopes(heads, 8).numpy(),
                                  np.asarray(jmpt.alibi_slopes(heads, 8)))


# -------------------------------------------------- captioner, tied head
class FakeTokenizer:
    """Characters as ids (tests/test_captioner.py's stand-in)."""

    def encode(self, s, add_special_tokens=False):
        return [min(ord(c), 250) for c in s[:40]]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(max(i, 32) % 127) for i in ids if i < 250)


def test_gemma_captioner_equal_jax(tmp_path):
    """A Gemma-geometry LLaVA (tied head, no lm_head in the checkpoint) read
    by JAX's loader and by the port's from_state_dict: the same greedy
    caption, and the projector sized by the decoder's width."""
    from safetensors.torch import save_file
    jl, tl = _cfgs("gemma")
    _V = dict(image_size=28, patch_size=14, width=24, layers=2, heads=2)
    jv, tv = JVisionConfig(**_V), CLIPVisionConfig(**_V)
    vtree = to_np(randomize(jax.eval_shape(JTower(jv).init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, 28, 28, 3))), 51))
    ptree = {"params": {"fc0": {"kernel": RNG.standard_normal((24, 32), np.float32) / 5,
                                "bias": RNG.standard_normal(32, np.float32) / 10},
                        "fc1": {"kernel": RNG.standard_normal((32, 32), np.float32) / 6,
                                "bias": RNG.standard_normal(32, np.float32) / 10}}}
    newline = RNG.standard_normal(32, np.float32)
    sd = llava_from_jax(_tree("gemma"), vtree, ptree, newline, tl, tv)
    assert "lm_head.weight" not in sd
    (tmp_path / "llava").mkdir()
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "llava" / "model.safetensors"))
    jcap = JCaptioner.load(tmp_path, llama_cfg=jl, vision_cfg=jv,
                           tokenizer=FakeTokenizer(), draft_dir=False)
    tcap = LlavaCaptioner.from_state_dict(sd, tl, tv, FakeTokenizer(), device="cpu")
    assert tcap.llama.lm_head is None
    img = Image.fromarray(RNG.integers(0, 255, (50, 70, 3), dtype=np.uint8))
    lcfg = LlavaConfig(max_new_tokens=16, temperature=0.0, do_sample=False)
    assert tcap.caption(img, lcfg) == jcap.caption(img, lcfg)
    seeded = LlavaCaptioner.seeded(tl, tv, FakeTokenizer(), device="cpu")
    assert seeded.projector[-1].out_features == 32
