"""Tensor-parallel Llama in the port (parallel/llama_sharding.py and the
TP forward of models/vlm/llama.py) on 4 gloo ranks of the CPU
(tests/torch_parallel_lib.py), at TP=2 (the 'data' groups of a 2 x 2
mesh) and TP=4, fp32 on a dense, int8, int4 (group 8) and MoE base, held
with JAX's own limits (atol 2e-4, rtol 1e-3, tests/test_llama_tp.py):

- TP logits equal the port's unsharded logits;
- TP logits equal JAX's TP logits (shard_llama_params on its 8-device CPU
  mesh) from the same Flax tree, loaded through params_from_jax and
  quantized by each package;
- each rank's q_proj holds 1 / n of its output rows (no silent
  replication);
- generate on the sharded decoder gives the unsharded ids, greedy and with
  the same injected Gumbel noise;
- llama_param_spec names JAX's split for every leaf of a small tree (dense,
  int8, int4, MoE), in the port's layouts;
- LlavaCaptioner.seeded / from_state_dict with a mesh, which build each
  rank's shard part by part, give exactly the whole captioner's decoder
  cut by shard_llama_ (dense, int8, int4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.models.vlm import llama as jllama
from rsvldm_tpu.parallel import make_mesh as jmake_mesh
from rsvldm_tpu.parallel.llama_sharding import (llama_param_spec as jspec,
                                                shard_kv_cache as jshard_cache,
                                                shard_llama_params)
from rsvldm_tpu_torch.models.vlm.llama import KVCache, LlamaConfig, LlamaModel
from rsvldm_tpu_torch.models.vlm.llama import quantize_llama_
from rsvldm_tpu_torch.parallel.llama_sharding import (llama_param_spec,
                                                      shard_kv_cache)
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parallel_lib import launch
from torch_parity_lib import randomize, to_np

RANKS = 4
BASE = dict(vocab_size=128, dim=32, layers=2, heads=8, kv_heads=4, ffn_dim=64)
MOE = dict(BASE, num_experts=4, experts_per_tok=2, moe_ffn_dim=16)
CASES = {"fp32": (BASE, None), "int8": (BASE, "int8"), "int4": (BASE, "int4"),
         "moe": (MOE, None)}
GROUP = 8  # int4 group: whole groups on each of 4 row shards at toy dims
TOKS = np.array([[3, 17, 99, 42, 7, 1, 0, 5]], np.int32)
NOISE = np.random.default_rng(3).gumbel(size=(6, 128)).astype(np.float32)
TOL = dict(atol=2e-4, rtol=1e-3)


def _tree(kw, seed):
    jm = jllama.LlamaModel(jllama.LlamaConfig(**kw))
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), jllama.KVCache.init(jm.cfg, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, seed))


def _jax_params(kw, mode, tree):
    """(JAX model, params) of a case, quantized as JAX does."""
    jcfg = jllama.LlamaConfig(**kw)
    if mode is None:
        return jllama.LlamaModel(jcfg), tree
    # the embedding narrowed to bf16, as the port's quantize_llama_ does
    q = {"params": jllama.quantize_llama_params(
        tree["params"], embed_dtype=jnp.bfloat16, mode=mode, group=GROUP)}
    return jllama.LlamaModel(dataclasses.replace(
        jcfg, quant=mode, quant_group=GROUP)), q


def _jax_logits(model, params, tp):
    toks = jnp.asarray(TOKS)
    cache = jllama.KVCache.init(model.cfg, 1, 16)
    f = lambda p, t, c: model.apply(p, t, c, 0, method=model.from_tokens)[0]
    if tp is None:
        return np.asarray(f(params, toks, cache))
    mesh = jmake_mesh(tp, tile=1)
    with mesh:
        return np.asarray(jax.jit(f)(shard_llama_params(params, mesh), toks,
                                     jshard_cache(cache, mesh)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("llama_tp")
    trees = {name: _tree(kw, 50 + i) for i, (name, (kw, _)) in enumerate(CASES.items())}
    cases = {name: dict(cfg=kw, mode=mode, group=GROUP,
                        sd=params_from_jax("llama", trees[name],
                                           LlamaConfig(**kw)))
             for name, (kw, mode) in CASES.items()}
    torch.save({"cases": cases, "toks": torch.from_numpy(TOKS).long(),
                "noise": torch.from_numpy(NOISE)}, work / "inputs.pt")
    ranks = launch("llama_tp", RANKS, work)
    return ranks, trees


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_logits_equal_unsharded(setup, name, tp):
    for res in setup[0]:
        np.testing.assert_allclose(res[name][tp]["logits"].numpy(),
                                   res[name]["unsharded"].numpy(), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_logits_equal_jax_tp(setup, name, tp):
    ranks, trees = setup
    kw, mode = CASES[name]
    model, params = _jax_params(kw, mode, trees[name])
    want = _jax_logits(model, params, tp)
    np.testing.assert_allclose(ranks[0][name][tp]["logits"].numpy(), want, **TOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_q_proj_rows_split(setup, name, tp):
    for res in setup[0]:
        assert res[name][tp]["q_rows"] * tp == res[name]["q_rows_full"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_generate_mesh_ids_equal(setup, name, tp):
    for res in setup[0]:
        assert res[name][tp]["greedy_equal"] is True
        assert res[name][tp]["sampled_equal"] is True


def _port_key(path: str):
    """A JAX leaf path -> (the port's name, how the port's layout maps JAX's
    dims: 't' transposed, 'moe' [E, d, f] -> [E, f, d], '' the same)."""
    parts = path.split("/")
    if parts[0] == "embed_tokens":
        return "model.embed_tokens.weight", ""
    if parts[0] == "norm":
        return "model.norm.weight", ""
    if parts[0] == "lm_head":
        leaf = parts[1]
        return ("lm_head.weight", "t") if leaf == "kernel" else (
            f"lm_head.{leaf}", "")
    i, mod, leaf = int(parts[0].split("_")[1]), parts[1], parts[-1]
    pre = f"model.layers.{i}"
    if mod in ("attn_norm", "mlp_norm"):
        name = "input_layernorm" if mod == "attn_norm" else "post_attention_layernorm"
        return f"{pre}.{name}.weight", ""
    if mod == "moe":
        if leaf.startswith("experts_"):
            return f"{pre}.block_sparse_moe.{leaf}", "moe"
        return f"{pre}.block_sparse_moe.gate.weight", "t"
    sub = "self_attn" if mod in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
    if leaf == "kernel":
        return f"{pre}.{sub}.{mod}.weight", "t"
    return f"{pre}.{sub}.{mod}.{leaf}", ""


@pytest.mark.parametrize("name", list(CASES))
def test_param_spec_names_jax_split(name):
    kw, mode = CASES[name]
    _, params = _jax_params(kw, mode, _tree(kw, 7))
    port = LlamaModel(LlamaConfig(**kw))
    if mode:
        quantize_llama_(port, mode, group=GROUP)
    named = dict(port.named_parameters())
    named.update(port.named_buffers())
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert leaves
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        want = tuple(jspec(path, leaf))
        want = want + (None,) * (leaf.ndim - len(want))
        pname, layout = _port_key(key)
        got = llama_param_spec(pname, named[pname])
        if layout == "t":
            got = got[::-1]
        elif layout == "moe":
            got = (got[0], got[2], got[1])
        assert got == want, (key, pname, got, want)


def test_shard_kv_cache_int8_scales():
    """The int8 KV cache's codes and scale planes split over kv heads
    (JAX tests/test_quant_kv.py::test_kv_quant_shard_cache); heads that do
    not divide stay whole."""
    cfg = LlamaConfig(**dict(BASE, kv_quant=True))
    cache = KVCache.init(cfg, 2, 8)
    cache.k_scale.copy_(torch.arange(cache.k_scale.numel(),
                                     dtype=torch.float32).reshape(cache.k_scale.shape))
    for rank in range(4):
        part = shard_kv_cache(cache, 4, rank)
        assert part.k.shape == (2, 2, 8, 1, cfg.head_dim)
        assert part.v_scale.shape == (2, 2, 8, 1)
        assert torch.equal(part.k_scale, cache.k_scale[..., rank:rank + 1])
    whole = shard_kv_cache(cache, 3, 1)
    assert whole.k.shape == cache.k.shape


@pytest.mark.parametrize("quant", ["None", "int8", "int4"])
def test_captioner_lean_build_equals_whole_then_sharded(setup, quant):
    for res in setup[0]:
        assert res["lean_build_equal"][quant]["seeded"] is True
        assert res["lean_build_equal"][quant]["from_state_dict"] is True
