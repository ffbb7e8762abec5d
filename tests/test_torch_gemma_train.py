"""The Gemma-family QLoRA step (VLMTrainer over a GEMMA_7B_CONFIG-shaped
decoder, JAX's own API: there is no Gemma training CLI in either package)
held against the JAX package at tiny geometry, fp32 on the CPU. The tiny
config keeps every Gemma knob: 256-wide heads that are not dim // heads
(q_proj's 512 outputs against dim 48, as Gemma-7B's 4096 against 3072),
(1 + w) norms, the embedding scale sqrt(dim) on the embeds-in path
vlm_loss takes, the lm_head tied to the embedding (narrowed to bf16 on
the int8 base, as both packages' quantizers do), tanh GELU, remat.

Tolerances as tests/test_torch_training.py: loss atol 1e-5; gradients
atol 2e-5 + rtol 1e-4; the adapters after three steps atol 1e-4 at lr
1e-2 (fp32, summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.vlm import llama as jllama
from rsvldm_tpu.training import vlm_trainer as jt
from rsvldm_tpu_torch.models.vlm import llama as tllama
from rsvldm_tpu_torch.training import vlm_trainer as tt
from rsvldm_tpu_torch.utils.weights import (lora_from_jax, lora_to_jax,
                                            params_from_jax)
from torch_parity_lib import randomize, to_np

torch.set_num_threads(1)
GEMMA = dict(vocab_size=64, dim=48, layers=2, heads=2, kv_heads=2,
             ffn_dim=64, head_dim_cfg=256, norm_plus_one=True,
             scale_embeds=True, tie_lm_head=True, act="gelu_tanh",
             rms_eps=1e-6, remat=True)
JC, TC = jllama.LlamaConfig(**GEMMA), tllama.LlamaConfig(**GEMMA)
LCFG = jt.LoraConfig(r=4, alpha=16)
TCFG = tt.LoraConfig(r=4, alpha=16)
B, S = 2, 12


@pytest.fixture(scope="module")
def tree():
    jm = jllama.LlamaModel(JC)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), jllama.KVCache.init(JC, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    tree = to_np(randomize(shapes, 81))
    # (1 + w) norms: w near 0, as Gemma's are
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x - 1.0 if "norm" in jax.tree_util.keystr(p) else x, tree)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :4] = tt.IGNORE_INDEX
    labels[1, -3:] = tt.IGNORE_INDEX
    return tokens, labels


def _pair(tree, mode):
    """(JAX module, JAX params, port model) on the same weights; int8 with
    the embedding (the tied head) narrowed to bf16 on both sides."""
    port = tllama.LlamaModel(TC)
    port.load_state_dict(params_from_jax("llama", tree, TC))
    port.requires_grad_(False)
    if mode is None:
        return jllama.LlamaModel(JC), tree, port
    qtree = {"params": jllama.quantize_llama_params(
        tree["params"], embed_dtype=jnp.bfloat16, mode=mode)}
    tllama.quantize_llama_(port, mode)
    return jllama.LlamaModel(dataclasses.replace(JC, quant=mode)), qtree, port


def _embeds(jm, jp, tm, tokens):
    """Both packages' embeddings of the tokens (the scale taken in fp32 and
    rounded to the table's dtype first); JAX's as numpy."""
    want = np.array(jm.apply(jp, jnp.asarray(tokens), method=jm.embed),
                     np.float32)
    with torch.no_grad():
        got = tm.embed(torch.from_numpy(tokens).long()).float()
    return got, want


def _cache(mode):
    return jllama.KVCache.init(dataclasses.replace(JC, quant=mode), B, S)


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _jax_lora(jparams, seed, bump=0.01):
    lora = jt.init_lora(jparams, LCFG, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda x: x + bump, lora)


def test_lora_shapes_follow_gemma_heads(tree):
    """Adapters sized by the projections, not by dim: q_proj's a [48, r],
    b [r, 2 x 256]; o_proj's a [512, r], b [r, 48]; the same as JAX's, and
    no lm_head (tied) among the targets."""
    _, jp, tm = _pair(tree, "int8")
    want = to_np(jt.init_lora(jp, LCFG, jax.random.PRNGKey(0)))
    got = lora_to_jax(tt.init_lora(tm, TCFG))
    assert got.keys() == want.keys()
    for layer, projs in want.items():
        assert got[layer].keys() == projs.keys()
        for proj, ab in projs.items():
            for n in ("a", "b"):
                assert got[layer][proj][n].shape == ab[n].shape
    assert want["layer_0"]["q_proj"]["b"].shape == (4, 512)
    assert want["layer_0"]["o_proj"]["a"].shape == (512, 4)
    assert tm.lm_head is None


@pytest.mark.parametrize("mode", [None, "int8"])
def test_gemma_loss_and_gradients_equal_jax(tree, batch, mode):
    """The embeds of the tokens (Gemma's scale, bf16-rounded on int8),
    vlm_loss on them under remat and every adapter gradient, nonzero b."""
    jm, jp, tm = _pair(tree, mode)
    tokens, labels = batch
    got_e, want_e = _embeds(jm, jp, tm, tokens)
    _close(got_e, want_e, atol=1e-6)
    jl = _jax_lora(jp, 4)
    want_loss, want = jax.jit(jax.value_and_grad(lambda l: jt.vlm_loss(
        jm, jp, l, LCFG, jnp.asarray(want_e), jnp.asarray(labels),
        _cache(mode))))(jl)
    lora = {p: {n: t.requires_grad_() for n, t in ab.items()}
            for p, ab in lora_from_jax(to_np(jl)).items()}
    loss = tt.vlm_loss(tm, lora, TCFG, torch.from_numpy(want_e),
                       torch.from_numpy(labels))
    leaves = [t for ab in lora.values() for t in ab.values()]
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    _close(float(loss.detach()), float(want_loss), atol=1e-5)
    got = lora_to_jax({p: {n: grads[id(t)] for n, t in ab.items()}
                       for p, ab in lora.items()})
    for layer, projs in to_np(want).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                _close(got[layer][proj][n], ab[n], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_gemma_three_trainer_steps_equal_jax(tree, batch, mode):
    """VLMTrainer from JAX's initial adapters over the Gemma decoder: the
    same three losses and adapters after them; the base's bytes (the tied
    table included) do not move."""
    jm, jp, tm = _pair(tree, mode)
    tokens, labels = batch
    emb = _embeds(jm, jp, tm, tokens)[1]
    jtr = jt.VLMTrainer(jm, jp, LCFG, lr=1e-2, rng=jax.random.PRNGKey(5))
    ttr = tt.VLMTrainer(tm, TCFG, lr=1e-2, lora=lora_from_jax(to_np(jtr.lora)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    for _ in range(3):
        want = jtr.train_step(jnp.asarray(emb), jnp.asarray(labels),
                              _cache(mode))
        got = ttr.train_step(torch.from_numpy(emb), torch.from_numpy(labels))
        _close(got, want, atol=1e-5)
    got = lora_to_jax(ttr.lora)
    for layer, projs in to_np(jtr.lora).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                _close(got[layer][proj][n], ab[n], atol=1e-4)
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())


def test_gemma_remat_equals_no_remat(tree, batch):
    """tanh GELU and the (1 + w) norms recomputed in the backward: the same
    loss and adapter gradients as without remat (int8 base)."""
    jm, jp, tm = _pair(tree, "int8")
    emb = torch.from_numpy(_embeds(jm, jp, tm, batch[0])[1])
    labels = torch.from_numpy(batch[1])
    lora = lora_from_jax(to_np(_jax_lora(jp, 9)))
    out = []
    for remat in (False, True):
        tm.cfg = dataclasses.replace(TC, remat=remat)
        leaves = {p: {n: t.clone().requires_grad_() for n, t in ab.items()}
                  for p, ab in lora.items()}
        loss = tt.vlm_loss(tm, leaves, TCFG, emb, labels)
        flat = [t for ab in leaves.values() for t in ab.values()]
        out.append((loss, torch.autograd.grad(loss, flat)))
    tm.cfg = TC
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-6, rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
