"""K1 and the fused backward at head dims above 256 (csrc/flash_wide.cu on
the card): their plain versions, the wrappers' padding and routing, and a
tiny decoder with wide heads, held against the JAX package on the CPU in
fp32 on the same numpy inputs.

- flash_attention_ref / flash_attention_bwd_ref at D = 320 and 512
  (causal and not, Sq != Sk, kv_len padding, lse) against JAX's Pallas
  flash_attention / flash_attention_bwd in interpret mode, S <= 128:
  within 1e-5 (fp32 on both sides, only the summation order differs);
- with_padded_head_dim past 256: D = 288 pads to 320 (the padded columns
  exact zeros, the rest the unpadded plain version's within 1e-6), 320 runs
  as it is;
- routing: the D each head dim runs at and whether it takes the wide
  kernels; CPU tensors at D = 512 take the plain versions and launch
  nothing;
- a tiny decoder with head_dim_cfg=320 (q_proj 48 -> 2 x 320, GQA, remat):
  logits, the LoRA loss, its gradients and one VLMTrainer step against
  JAX: logits and loss within 1e-5, gradients 2e-5 + 1e-4 relative,
  adapters within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.vlm import llama as jllama
from rsvldm_tpu.ops.flash_attention import flash_attention as jax_flash
from rsvldm_tpu.ops.flash_attention import flash_attention_bwd as jax_bwd
from rsvldm_tpu.training import vlm_trainer as jt
from rsvldm_tpu_torch.models.vlm import llama as tllama
from rsvldm_tpu_torch.ops import flash_attention as fa
from rsvldm_tpu_torch.training import vlm_trainer as tt
from rsvldm_tpu_torch.utils.weights import (lora_from_jax, lora_to_jax,
                                            params_from_jax)
from torch_parity_lib import randomize, to_np

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)


CASES = [(96, 96, True), (64, 128, True), (100, 72, False), (128, 128, False)]


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_forward_equals_pallas(sq, sk, causal, d):
    q, k, v, _ = _inputs(1, sq, sk, 2, d, sq + sk + d)
    out_j, lse_j = jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=causal, block_q=64, block_k=64,
                             interpret=True, return_lse=True)
    out_t, lse_t = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                      causal=causal, return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("d,causal", [(320, True), (512, False)])
def test_plain_forward_kv_len_padding(d, causal):
    """Keys at or past kv_len are padding: JAX on the unpadded keys."""
    sq, sk, kv_len = 80, 128, 99
    q, k, v, _ = _inputs(1, sq, sk, 2, d, d + causal)
    pad = lambda x: np.concatenate(
        [x[:, :kv_len], np.full_like(x[:, kv_len:], 7.0)], axis=1)
    out_t, lse_t = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(pad(k)), torch.from_numpy(pad(v)),
        causal=causal, kv_len=kv_len, return_lse=True)
    out_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                             jnp.asarray(v[:, :kv_len]), causal=causal,
                             block_q=64, block_k=64, interpret=True,
                             return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("sq,sk,causal", CASES)
def test_plain_backward_equals_pallas(sq, sk, causal, d):
    q, k, v, g = _inputs(1, sq, sk, 2, d, 3 * sq + sk + d)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                         interpret=True, return_lse=True)
    want = jax_bwd(jq, jk, jv, out, lse, jg, causal=causal, block_q=64,
                   block_k=64, interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    o_t, lse_t = fa.flash_attention(*t[:3], causal=causal, return_lse=True)
    got = fa.flash_attention_bwd(*t[:3], o_t, lse_t, t[3], causal=causal)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("d", [288, 320])
def test_padded_head_dim_past_256(d):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 70, 90, 2, d, d))
    assert fa.padded_head_dim(d) == 320
    out, lse = fa.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    seen = []

    def plain(*xs, **kw):
        seen.append(xs[0].shape[-1])
        res = fa.flash_attention_ref(*xs, **kw)
        seen.append(res)
        return res

    got, got_lse = fa.with_padded_head_dim(plain, q, k, v, causal=True,
                                           return_lse=True)
    assert seen[0] == 320 and got.shape[-1] == d
    if d == 320:   # no padding: the plain version's own result
        assert seen[1][0] is got and torch.equal(got_lse, lse)
    assert (seen[1][0][..., d:] == 0).all()
    torch.testing.assert_close(got, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got_lse, lse, atol=1e-6, rtol=1e-6)
    seen.clear()

    def plain_bwd(*xs, **kw):
        res = fa.flash_attention_bwd_ref(*xs, **kw)
        seen.append(res)
        return res

    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=True)
    got = fa.with_padded_head_dim(plain_bwd, q, k, v, out, lse, g,
                                  causal=True)
    for x, w, full in zip(got, want, seen[0]):
        torch.testing.assert_close(x, w, atol=1e-6, rtol=1e-6)
        assert (full[..., d:] == 0).all()


@pytest.mark.parametrize("d,runs_at,wide", [
    (64, 64, False), (104, 128, False), (192, 256, False), (256, 256, False),
    (257, 320, True), (288, 320, True), (320, 320, True), (384, 384, True),
    (512, 512, True), (600, 640, True)])
def test_routing(d, runs_at, wide):
    assert fa.padded_head_dim(d) == runs_at
    assert fa.is_wide(runs_at) is wide


def test_cpu_tensors_take_the_plain_versions():
    """At D = 512 a CPU call computes the plain versions, raises nothing and
    counts no launch; with a gradient it goes through FlashAttention's
    plain forward and backward."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 40, 40, 2, 512, 1))
    counts = lambda: (fa.flash_attention.launches,
                      fa.flash_attention.launches_wide,
                      fa.flash_attention_bwd.launches,
                      fa.flash_attention_bwd.launches_wide)
    before = counts()
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    want = fa.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    for x, w in zip(grads, fa.flash_attention_bwd_ref(q, k, v, out, lse, g,
                                                      causal=True)):
        assert torch.equal(x, w)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True)
    (o * g).sum().backward()
    for x, w in zip(leaves, grads):
        torch.testing.assert_close(x.grad, w, atol=1e-6, rtol=1e-6)
    assert counts() == before


# ------------------------------------------------ a decoder with wide heads
WIDE = dict(vocab_size=64, dim=48, layers=2, heads=2, kv_heads=1,
            ffn_dim=64, head_dim_cfg=320, remat=True)
JC, TC = jllama.LlamaConfig(**WIDE), tllama.LlamaConfig(**WIDE)
LCFG = jt.LoraConfig(r=4, alpha=16)
TCFG = tt.LoraConfig(r=4, alpha=16)
B, S = 2, 12


@pytest.fixture(scope="module")
def tree():
    jm = jllama.LlamaModel(JC)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), jllama.KVCache.init(JC, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, 83))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (B, S)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :4] = tt.IGNORE_INDEX
    return tokens, labels


def _port(tree):
    port = tllama.LlamaModel(TC)
    port.load_state_dict(params_from_jax("llama", tree, TC))
    return port.requires_grad_(False)


def _embeds(jm, tree, tokens):
    return np.array(jm.apply(tree, jnp.asarray(tokens), method=jm.embed),
                    np.float32)


def test_wide_decoder_logits_equal_jax(tree, batch):
    jm, tm = jllama.LlamaModel(JC), _port(tree)
    assert tm.model.layers[0].self_attn.q_proj.weight.shape == (2 * 320, 48)
    tokens = batch[0]
    want, _ = jm.apply(tree, jnp.asarray(tokens),
                       jllama.KVCache.init(JC, B, S), 0,
                       method=jm.from_tokens)
    with torch.no_grad():
        got, _ = tm(tm.embed(torch.from_numpy(tokens).long()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wide_decoder_lora_step_equals_jax(tree, batch):
    """vlm_loss and its adapter gradients under remat, then one VLMTrainer
    step from JAX's initial adapters: the same loss and adapters."""
    jm, tm = jllama.LlamaModel(JC), _port(tree)
    tokens, labels = batch
    emb = _embeds(jm, tree, tokens)
    jl = jax.tree_util.tree_map(
        lambda x: x + 0.01, jt.init_lora(tree, LCFG, jax.random.PRNGKey(4)))
    want_loss, want = jax.jit(jax.value_and_grad(lambda l: jt.vlm_loss(
        jm, tree, l, LCFG, jnp.asarray(emb), jnp.asarray(labels),
        jllama.KVCache.init(JC, B, S))))(jl)
    lora = {p: {n: t.requires_grad_() for n, t in ab.items()}
            for p, ab in lora_from_jax(to_np(jl)).items()}
    loss = tt.vlm_loss(tm, lora, TCFG, torch.from_numpy(emb),
                       torch.from_numpy(labels))
    leaves = [t for ab in lora.values() for t in ab.values()]
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5)
    got = lora_to_jax({p: {n: grads[id(t)] for n, t in ab.items()}
                       for p, ab in lora.items()})
    for layer, projs in to_np(want).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                np.testing.assert_allclose(got[layer][proj][n], ab[n],
                                           atol=2e-5, rtol=1e-4)
    jtr = jt.VLMTrainer(jm, tree, LCFG, lr=1e-2, rng=jax.random.PRNGKey(5))
    ttr = tt.VLMTrainer(tm, TCFG, lr=1e-2, lora=lora_from_jax(to_np(jtr.lora)))
    want_l = jtr.train_step(jnp.asarray(emb), jnp.asarray(labels),
                            jllama.KVCache.init(JC, B, S))
    got_l = ttr.train_step(torch.from_numpy(emb), torch.from_numpy(labels))
    np.testing.assert_allclose(got_l, float(want_l), atol=1e-5)
    got = lora_to_jax(ttr.lora)
    for layer, projs in to_np(jtr.lora).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                np.testing.assert_allclose(got[layer][proj][n], ab[n],
                                           atol=1e-4)
