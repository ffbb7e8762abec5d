"""The port's QLoRA finetune held against the JAX package at tiny geometry,
fp32 on the CPU: the straight-through products, the runtime LoRA branch and
the fp fold-in, the adapter gradients of one loss, three VLMTrainer steps
(AdamW), remat, the int8 merge and the adapter archives. The same weights
(a numpy-randomized Flax tree through params_from_jax), embeddings, labels
and adapters (JAX's, carried across with lora_from_jax) go to both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.llama import quantize_llama_params
from rsvldm_tpu.ops import quant as jquant
from rsvldm_tpu.training import vlm_trainer as jt
from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel, Q4Dense,
                                               QDense, quantize_llama_)
from rsvldm_tpu_torch.ops.quant import Int4Linear, QuantizedLinear
from rsvldm_tpu_torch.training import vlm_trainer as tt
from rsvldm_tpu_torch.utils.weights import (lora_from_jax, lora_module_path,
                                            lora_to_jax, params_from_jax)
from torch_parity_lib import randomize, to_np

torch.set_num_threads(1)
_L = dict(vocab_size=64, dim=32, layers=2, heads=2, kv_heads=1, ffn_dim=64)
JL, TL = JLlamaConfig(**_L), LlamaConfig(**_L)
LCFG = jt.LoraConfig(r=4, alpha=16)  # scale 4
TCFG = tt.LoraConfig(r=4, alpha=16)
B, S = 2, 12


@pytest.fixture(scope="module")
def tree():
    jm = JLlama(JL)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(JL, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, 31))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    emb = (rng.standard_normal((B, S, 32)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 64, (B, S)).astype(np.int32)
    labels[:, :4] = tt.IGNORE_INDEX
    labels[1, -2:] = tt.IGNORE_INDEX
    return emb, labels


def _pair(tree, mode):
    """(JAX module, JAX params, port model) on the same weights."""
    port = LlamaModel(TL)
    port.load_state_dict(params_from_jax("llama", tree, TL))
    port.requires_grad_(False)
    if mode is None:
        return JLlama(JL), tree, port
    qtree = {"params": quantize_llama_params(tree["params"], mode=mode)}
    quantize_llama_(port, mode, embed_dtype=torch.float32)
    return JLlama(dataclasses.replace(JL, quant=mode)), qtree, port


def _jax_lora(jparams, seed, bump=0.01):
    lora = jt.init_lora(jparams, LCFG, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda x: x + bump, lora)


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------- STE
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_ste_gradient_equals_jax(mode):
    """d/dx of sum(QDense(x) * g) is g @ W_deq^T, as JAX's
    int8_matmul_ste / int4_matmul_ste give; the integer product alone
    would leave 1-2 nonzero elements a row. fp32, atol 1e-5 (measured: 0,
    the same fp32 product)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 64)) / 16).astype(np.float32)
    g = rng.standard_normal((3, 64)).astype(np.float32)
    if mode == "int8":
        ql = jquant.quantize_weight(jnp.asarray(w))
        fn = lambda x: jnp.sum(jquant.int8_matmul_ste(
            x, ql.q, ql.scale, jnp.float32) * g)
        layer = QDense(QuantizedLinear(torch.from_numpy(np.asarray(ql.q)),
                                       torch.from_numpy(np.asarray(ql.scale))))
    else:
        ql = jquant.quantize_weight_int4(jnp.asarray(w))
        fn = lambda x: jnp.sum(jquant.int4_matmul_ste(
            x, ql.packed, ql.scale, jnp.float32) * g)
        layer = Q4Dense(Int4Linear(torch.from_numpy(np.asarray(ql.packed)),
                                   torch.from_numpy(np.asarray(ql.scale))))
    want = jax.grad(fn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad((layer(xt) * torch.from_numpy(g)).sum(), xt)
    _close(got, want, atol=1e-5)
    assert (got != 0).sum(-1).min() == 256


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_zero_b_adapters_leave_the_forward_unchanged(tree, batch, mode):
    """Exactly the base forward, which is JAX's within 1e-4 (measured
    6e-8)."""
    jm, jp, tm = _pair(tree, mode)
    lora = lora_from_jax(to_np(jt.init_lora(jp, LCFG, jax.random.PRNGKey(1))))
    emb = torch.from_numpy(batch[0])
    with torch.no_grad():
        base, _ = tm(emb)
        with_l, _ = tt.apply_model(tm, lora, TCFG, emb)
    assert torch.equal(base, with_l)
    want, _ = jm.apply(jp, jnp.asarray(batch[0]), JKVCache.init(JL, B, S), 0)
    _close(base, want, atol=1e-4)


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_lora_gradients_equal_jax(tree, batch, mode):
    """The loss and every adapter gradient of one forward/backward, with
    nonzero B as in tests/test_qlora.py: loss within 1e-5, gradients within
    2e-5 + 1e-4 relative (measured max |err| 2.1e-9 over both)."""
    jm, jp, tm = _pair(tree, mode)
    jl = _jax_lora(jp, 4)
    emb, labels = batch
    cache = JKVCache.init(dataclasses.replace(JL, quant=mode), B, S)
    want_loss, want = jax.value_and_grad(lambda l: jt.vlm_loss(
        jm, jp, l, LCFG, jnp.asarray(emb), jnp.asarray(labels), cache))(jl)
    lora = {p: {n: t.requires_grad_() for n, t in ab.items()}
            for p, ab in lora_from_jax(to_np(jl)).items()}
    loss = tt.vlm_loss(tm, lora, TCFG, torch.from_numpy(emb),
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


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_three_trainer_steps_equal_jax(tree, batch, mode):
    """VLMTrainer (AdamW over the adapters) from JAX's initial adapters:
    the same three losses (atol 1e-5) and the same adapters after them
    (atol 1e-4, 1% of one step at lr 1e-2: Adam's normalized step turns
    fp32 rounding of the smallest gradients into larger moves; measured
    max |err| 1.0e-6 fp, 3.2e-5 int8, 1.3e-6 int4); the base's bytes do
    not move."""
    jm, jp, tm = _pair(tree, mode)
    jtr = jt.VLMTrainer(jm, jp, LCFG, lr=1e-2, rng=jax.random.PRNGKey(5))
    ttr = tt.VLMTrainer(tm, TCFG, lr=1e-2, lora=lora_from_jax(to_np(jtr.lora)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    emb, labels = batch
    cache = JKVCache.init(dataclasses.replace(JL, quant=mode), B, S)
    for _ in range(3):
        want = jtr.train_step(jnp.asarray(emb), jnp.asarray(labels), cache)
        got = ttr.train_step(torch.from_numpy(emb), torch.from_numpy(labels))
        _close(got, want, atol=1e-5)
    got = lora_to_jax(ttr.lora)
    for layer, projs in to_np(jtr.lora).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                _close(got[layer][proj][n], ab[n], atol=1e-4)
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())
    assert float(ttr.lora["model.layers.0.self_attn.q_proj"]["b"].detach()
                 .abs().max()) > 0


def test_remat_equals_no_remat(tree, batch):
    """Per-block recompute (non-reentrant checkpoint), int8 base, no KV
    cache: the same loss and adapter gradients, with K/V never written."""
    _, jp, tm = _pair(tree, "int8")
    lora = lora_from_jax(to_np(_jax_lora(jp, 9)))
    emb, labels = (torch.from_numpy(x) for x in batch)
    out = []
    for remat in (False, True):
        tm.cfg = dataclasses.replace(TL, remat=remat)
        leaves = {p: {n: t.clone().requires_grad_() for n, t in ab.items()}
                  for p, ab in lora.items()}
        loss = tt.vlm_loss(tm, leaves, TCFG, emb, labels)
        flat = [t for ab in leaves.values() for t in ab.values()]
        out.append((loss, torch.autograd.grad(loss, flat)))
    tm.cfg = TL
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-6, rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------- merge and archives
def test_export_merged_int8_equals_jax(tree):
    """The merged int8 bytes equal JAX's but for round-half ties of the
    delta (at most one step, on under 0.1% of them) and the scales agree
    within 1e-6 relative (measured max |err| 2.3e-10)."""
    _, jp, tm = _pair(tree, "int8")
    jl = _jax_lora(jp, 11, bump=0.05)
    want = jt.export_merged(jp, jl, LCFG)["params"]
    got = tt.export_merged(tm, lora_from_jax(to_np(jl)), TCFG)
    for i in range(TL.layers):
        for sub, proj in (("self_attn", "q_proj"), ("mlp", "down_proj")):
            w = want[f"layer_{i}"][proj]
            pre = f"model.layers.{i}.{sub}.{proj}"
            q_diff = np.abs(got[f"{pre}.kernel_q"].numpy().astype(np.int32)
                            - np.asarray(w["kernel_q"], np.int32))
            assert q_diff.max() <= 1 and q_diff.mean() < 1e-3  # RTN ties
            _close(got[f"{pre}.scale"], w["scale"], atol=1e-7, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tt.export_merged(_pair(tree, "int4")[2], {}, TCFG)


def test_lora_archives_interchange(tree, tmp_path):
    """An archive written by either package loads in the other with the
    same arrays and LoraConfig."""
    _, jp, _ = _pair(tree, None)
    jl = _jax_lora(jp, 12)
    cfg = jt.LoraConfig(r=4, alpha=8)
    jt.save_lora_npz(jl, cfg, tmp_path / "jax.npz")
    lora, tcfg = tt.load_lora_npz(tmp_path / "jax.npz")
    assert (tcfg.r, tcfg.alpha, tuple(tcfg.targets)) == (4, 8, tuple(cfg.targets))
    tt.save_lora_npz(lora, tcfg, tmp_path / "port.npz")
    back, bcfg = jt.load_lora_npz(tmp_path / "port.npz")
    assert bcfg == cfg
    want = to_np(jl)
    assert {(k, p) for k, v in back.items() for p in v} == \
        {(k, p) for k, v in want.items() for p in v}
    for layer, projs in want.items():
        for proj, ab in projs.items():
            port_ab = lora[lora_module_path(int(layer[6:]), proj)]
            for n in ("a", "b"):
                np.testing.assert_array_equal(np.asarray(back[layer][proj][n]),
                                              ab[n])
                np.testing.assert_array_equal(port_ab[n].numpy(), ab[n])
