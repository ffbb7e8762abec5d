"""The port's projector tuning (mm_loss, MMTrainer) and DPO (dpo_loss,
DPOTrainer) held against the JAX package at tiny geometry, fp32 on the CPU,
on fp, int8 and int4 bases: the same weights (a numpy-randomized Flax tree
through params_from_jax), projector, embeddings, labels and adapters (JAX's,
carried across with lora_from_jax). Tolerances as tests/test_torch_training
.py: loss atol 1e-5; gradients atol 2e-5 + rtol 1e-4; trainable leaves after
three steps atol 1e-4 at lr 1e-2."""

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
from rsvldm_tpu.models.vlm.projector import MLPProjector as JProjector
from rsvldm_tpu.training import vlm_trainer as jt
from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                               quantize_llama_)
from rsvldm_tpu_torch.models.vlm.projector import MLPProjector
from rsvldm_tpu_torch.training import vlm_trainer as tt
from rsvldm_tpu_torch.utils.weights import (lora_from_jax, lora_to_jax,
                                            params_from_jax)
from torch_parity_lib import randomize, to_np

torch.set_num_threads(1)
_L = dict(vocab_size=64, dim=32, layers=2, heads=2, kv_heads=1, ffn_dim=64)
JL, TL = JLlamaConfig(**_L), LlamaConfig(**_L)
LCFG = jt.LoraConfig(r=4, alpha=16)
TCFG = tt.LoraConfig(r=4, alpha=16)
B, S, T, DV = 2, 14, 4, 8
POS = np.array([3, 6])


@pytest.fixture(scope="module")
def tree():
    jm = JLlama(JL)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(JL, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, 41))


@pytest.fixture(scope="module")
def proj_tree():
    jm = JProjector(out_dim=32)
    return to_np(randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, T, DV))), 42))


@pytest.fixture(scope="module")
def mm_batch():
    """Tower features, text embeddings with a zero span of T rows at POS[b]
    (labels IGNORE there and on the prompt), labels."""
    rng = np.random.default_rng(5)
    vis = rng.standard_normal((B, T, DV)).astype(np.float32)
    emb = (rng.standard_normal((B, S, 32)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 64, (B, S)).astype(np.int32)
    for b, p in enumerate(POS):
        emb[b, p:p + T] = 0
        labels[b, :p + T] = tt.IGNORE_INDEX
    labels[1, -2:] = tt.IGNORE_INDEX
    return vis, emb, labels


@pytest.fixture(scope="module")
def pairs():
    """(chosen embeds, chosen labels, rejected embeds, rejected labels)."""
    rng = np.random.default_rng(6)
    out = []
    for _ in range(2):
        emb = (rng.standard_normal((B, S, 32)) * 0.5).astype(np.float32)
        labels = rng.integers(0, 64, (B, S)).astype(np.int32)
        labels[:, :5] = tt.IGNORE_INDEX
        out += [emb, labels]
    out[3][0, -3:] = tt.IGNORE_INDEX
    return out


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


def _projector(proj_tree):
    m = MLPProjector(DV, 32)
    m.load_state_dict(params_from_jax("projector", proj_tree, None))
    return m


def _jax_lora(jparams, seed, bump=0.01):
    lora = jt.init_lora(jparams, LCFG, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda x: x + bump, lora)


def _cache(mode):
    return JKVCache.init(dataclasses.replace(JL, quant=mode), B, S)


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _lora_close(got_lora, want_tree, atol, rtol=1e-5):
    got = lora_to_jax(got_lora)
    for layer, projs in to_np(want_tree).items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                _close(got[layer][proj][n], ab[n], atol, rtol)


def _proj_close(got_sd, want_tree, atol, rtol=1e-5):
    want = params_from_jax("projector", to_np(want_tree), None)
    assert set(got_sd) == set(want)
    for k, v in want.items():
        _close(got_sd[k].detach(), v, atol, rtol)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_mm_loss_gradients_equal_jax(tree, proj_tree, mm_batch, mode):
    """mm_loss with the projector and the adapters both differentiated: the
    loss, every projector leaf's and every adapter's gradient. The span is
    written out of place, so the projector's gradient comes back through
    both blocks (and the STE of a quantized base)."""
    jm, jp, tm = _pair(tree, mode)
    jl = _jax_lora(jp, 3)
    vis, emb, labels = mm_batch
    jproj = JProjector(out_dim=32)
    want_loss, (want_l, want_p) = jax.jit(jax.value_and_grad(
        lambda l, pp: jt.mm_loss(jm, jp, l, LCFG, jproj, pp, jnp.asarray(vis),
                                 jnp.asarray(emb), jnp.asarray(POS),
                                 jnp.asarray(labels), _cache(mode)),
        argnums=(0, 1)))(jl, proj_tree)
    proj = _projector(proj_tree)
    lora = {p: {n: t.requires_grad_() for n, t in ab.items()}
            for p, ab in lora_from_jax(to_np(jl)).items()}
    loss = tt.mm_loss(tm, lora, TCFG, proj, torch.from_numpy(vis),
                      torch.from_numpy(emb), POS, torch.from_numpy(labels))
    leaves = [t for ab in lora.values() for t in ab.values()]
    pnames, pleaves = zip(*proj.named_parameters())
    grads = torch.autograd.grad(loss, leaves + list(pleaves))
    _close(float(loss.detach()), float(want_loss), atol=1e-5)
    by_id = dict(zip(map(id, leaves), grads[:len(leaves)]))
    _lora_close({p: {n: by_id[id(t)] for n, t in ab.items()}
                 for p, ab in lora.items()}, want_l, 2e-5, 1e-4)
    _proj_close(dict(zip(pnames, grads[len(leaves):])), want_p, 2e-5, 1e-4)
    assert all(float(g.abs().max()) > 0 for g in grads[len(leaves):])


def test_splice_span_clamps_as_dynamic_update_slice():
    """A start past S - T is clamped, as JAX's dynamic_update_slice."""
    e = torch.zeros((2, 6, 3))
    f = torch.ones((2, 4, 3))
    out = tt.splice_span(e, f, [1, 5])
    want = jax.vmap(lambda a, b, p: jax.lax.dynamic_update_slice(a, b, (p, 0)))(
        jnp.zeros((2, 6, 3)), jnp.ones((2, 4, 3)), jnp.asarray([1, 5]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("tune,mode", [
    (("projector",), None), (("projector",), "int8"),
    (("lora", "projector"), "int8"), (("lora", "projector"), "int4")])
def test_three_mm_trainer_steps_equal_jax(tree, proj_tree, mm_batch, tune,
                                          mode):
    """MMTrainer from JAX's adapters and projector, the projector in its own
    AdamW group at mm_projector_lr 3e-3 against lr 1e-2: three losses
    (atol 1e-5), the trainable leaves after them (atol 1e-4); the base's
    bytes do not move and a projector-only run has no adapters."""
    jm, jp, tm = _pair(tree, mode)
    jtr = jt.MMTrainer(jm, jp, JProjector(out_dim=32), proj_tree, LCFG,
                       tune=tune, lr=1e-2, mm_projector_lr=3e-3,
                       rng=jax.random.PRNGKey(8))
    proj = _projector(proj_tree)
    ttr = tt.MMTrainer(tm, proj, TCFG, tune=tune, lr=1e-2,
                       mm_projector_lr=3e-3,
                       lora=(lora_from_jax(to_np(jtr.lora))
                             if "lora" in tune else None))
    assert [g["lr"] for g in ttr.opt.param_groups] == (
        [1e-2, 3e-3] if "lora" in tune else [3e-3])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    vis, emb, labels = mm_batch
    for _ in range(3):
        want = jtr.train_step(jnp.asarray(vis), jnp.asarray(emb), POS,
                              jnp.asarray(labels), _cache(mode))
        got = ttr.train_step(torch.from_numpy(vis), torch.from_numpy(emb),
                             POS, torch.from_numpy(labels))
        _close(got, want, atol=1e-5)
    _proj_close(proj.state_dict(), jtr.proj_params, 1e-4)
    if "lora" in tune:
        _lora_close(ttr.lora, jtr.lora, 1e-4)
    else:
        assert ttr.lora is None and jtr.lora is None
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())


def test_frozen_projector_stays_put(tree, proj_tree, mm_batch):
    """tune=("lora",) through MMTrainer: the projector never requires grad
    and its bytes do not move; the adapters do."""
    _, jp, tm = _pair(tree, "int8")
    proj = _projector(proj_tree)
    before = {k: v.clone() for k, v in proj.state_dict().items()}
    ttr = tt.MMTrainer(tm, proj, TCFG, tune=("lora",), lr=1e-2,
                       lora=lora_from_jax(to_np(_jax_lora(jp, 2))))
    vis, emb, labels = mm_batch
    for _ in range(2):
        ttr.train_step(torch.from_numpy(vis), torch.from_numpy(emb), POS,
                       torch.from_numpy(labels))
    assert not any(p.requires_grad for p in proj.parameters())
    assert all(torch.equal(v, proj.state_dict()[k]) for k, v in before.items())
    with pytest.raises(ValueError, match="tune"):
        tt.MMTrainer(tm, proj, TCFG, tune=("vision",))


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_dpo_loss_and_gradients_equal_jax(tree, pairs, mode):
    """dpo_loss (beta 0.3): the loss and every adapter gradient; the
    reference forwards run without a graph."""
    jm, jp, tm = _pair(tree, mode)
    jl = _jax_lora(jp, 4, bump=0.05)
    jargs = [jnp.asarray(x) for x in pairs]
    want_loss, want = jax.jit(jax.value_and_grad(lambda l: jt.dpo_loss(
        jm, jp, l, LCFG, *jargs, _cache(mode), beta=0.3)))(jl)
    lora = {p: {n: t.requires_grad_() for n, t in ab.items()}
            for p, ab in lora_from_jax(to_np(jl)).items()}
    loss = tt.dpo_loss(tm, lora, TCFG, *(torch.from_numpy(x) for x in pairs),
                       beta=0.3)
    leaves = [t for ab in lora.values() for t in ab.values()]
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    _close(float(loss.detach()), float(want_loss), atol=1e-5)
    _lora_close({p: {n: by_id[id(t)] for n, t in ab.items()}
                 for p, ab in lora.items()}, want, 2e-5, 1e-4)
    emb, lab = (torch.from_numpy(x) for x in pairs[:2])
    got_lp = tt.sequence_logprob(tm, emb, lab)
    want_lp = jax.jit(lambda e, l: jt._sequence_logprob(
        jm, jp, e, l, _cache(mode)))(jargs[0], jargs[1])
    _close(got_lp.detach(), want_lp, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_three_dpo_trainer_steps_equal_jax(tree, pairs, mode):
    """DPOTrainer (lr 1e-2, beta 0.1) from JAX's adapters: three losses
    (atol 1e-5) and the adapters after them (atol 1e-4)."""
    jm, jp, tm = _pair(tree, mode)
    jtr = jt.DPOTrainer(jm, jp, LCFG, lr=1e-2, rng=jax.random.PRNGKey(6))
    ttr = tt.DPOTrainer(tm, TCFG, lr=1e-2, lora=lora_from_jax(to_np(jtr.lora)))
    assert ttr.beta == jtr.beta == 0.1
    assert tt.DPOTrainer(tm, TCFG).opt.param_groups[0]["lr"] == 5e-5
    for _ in range(3):
        want = jtr.train_step(*(jnp.asarray(x) for x in pairs), _cache(mode))
        got = ttr.train_step(*(torch.from_numpy(x) for x in pairs))
        _close(got, want, atol=1e-5)
    _lora_close(ttr.lora, jtr.lora, 1e-4)


def test_projector_archives_interchange(proj_tree, tmp_path):
    """save_projector_npz writes the JAX archive's keys: either package reads
    the other's with the same arrays."""
    jt.save_projector_npz(proj_tree, tmp_path / "jax.npz")
    sd = tt.load_projector_npz(tmp_path / "jax.npz")
    proj = MLPProjector(DV, 32)
    proj.load_state_dict(sd)
    tt.save_projector_npz(proj, tmp_path / "port.npz")
    z = np.load(tmp_path / "port.npz")
    assert sorted(z.files) == sorted(np.load(tmp_path / "jax.npz").files)
    back = to_np(jt.load_projector_npz(tmp_path / "port.npz"))
    for k in ("fc0", "fc1"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"][k][leaf],
                                          proj_tree["params"][k][leaf])
