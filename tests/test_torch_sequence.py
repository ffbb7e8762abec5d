"""The port's sequence parallelism (rsvldm_tpu_torch/parallel/sequence.py)
on four gloo ranks of the CPU (tests/torch_parallel_lib.py, one launch for
the file), held against the JAX package's functions on four virtual CPU
devices, the cases of tests/test_parallel_spp.py, fp32:

- sequence_parallel_attention over an ("sp",) mesh, each rank holding 4
  of 16 rows, for causal x kv heads 4 and 2 (GQA): the ranks' rows
  together equal JAX's within 1e-5;
- gpipe_apply over a ("stage",) mesh, 4 tanh stages and 6 microbatches,
  from the whole stack: JAX's within 1e-5 on every rank;
- the tiny decoder's blocks one a stage, each rank passing its own slice,
  then the final norm and lm_head: JAX's pipelined logits and its
  unpipelined forward within 2e-4."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaBlock as JBlock
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.llama import RMSNorm as JRMSNorm
from rsvldm_tpu.parallel.sequence import (gpipe_apply,
                                          sequence_parallel_attention,
                                          stack_stage_params)
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.utils.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_lib import launch  # noqa: E402

RANKS = 4
SP_CASES = [(causal, kvh) for causal in (True, False) for kvh in (4, 2)]
LLAMA = dict(vocab_size=32, dim=16, layers=4, heads=2, kv_heads=2,
             ffn_dim=32)
TOKS = np.asarray([[1, 5, 9]], np.int32)


def _mesh(name):
    return Mesh(np.array(jax.devices()[:RANKS]), (name,))


def _sp_inputs(kvh):
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 16, 4, 8
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32),
            rng.normal(size=(b, s, kvh, d)).astype(np.float32))


def _gpipe_inputs():
    rng = np.random.default_rng(1)
    dim, m = 8, 6
    stages = [{"w": (rng.normal(size=(dim, dim)) * 0.3).astype(np.float32),
               "b": rng.normal(size=(dim,)).astype(np.float32)}
              for _ in range(RANKS)]
    return stages, rng.normal(size=(m, 3, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def llama():
    cfg = JLlamaConfig(**LLAMA)
    lm = JLlama(cfg)
    cache = JKVCache.init(cfg, 1, 8)
    params = lm.init(jax.random.PRNGKey(0), jnp.asarray(TOKS), cache, 0,
                     method=lm.from_tokens)
    ref, _ = lm.apply(params, jnp.asarray(TOKS), cache, 0,
                      method=lm.from_tokens)
    return cfg, params, np.asarray(ref)


@pytest.fixture(scope="module")
def ranks(llama, tmp_path_factory):
    work = tmp_path_factory.mktemp("sequence")
    t = lambda x: torch.from_numpy(np.asarray(x))
    stages, x = _gpipe_inputs()
    _, params, _ = llama
    sd = params_from_jax("llama", jax.tree_util.tree_map(np.asarray, params),
                         LlamaConfig(**LLAMA))
    torch.save({
        "sp": {(c, kvh): tuple(t(a) for a in _sp_inputs(kvh))
               for c, kvh in SP_CASES},
        "gpipe": {"stages": [{k: t(v) for k, v in st.items()}
                             for st in stages], "x": t(x)},
        "llama": {"geom": LLAMA, "sd": sd, "toks": t(TOKS).long()},
    }, work / "inputs.pt")
    return launch("sequence", RANKS, work)


def test_meshes_are_one_axis(ranks):
    for res in ranks:
        assert res["sp_mesh"] == (("sp",), (RANKS,))


@pytest.mark.parametrize("causal,kvh", SP_CASES)
def test_sp_attention_equals_jax(ranks, causal, kvh):
    q, k, v = (jnp.asarray(a) for a in _sp_inputs(kvh))
    mesh = _mesh("sp")
    spec = NamedSharding(mesh, P(None, "sp"))
    want = jax.jit(lambda a, b, c: sequence_parallel_attention(
        a, b, c, mesh, "sp", causal=causal))(
        *(jax.device_put(x, spec) for x in (q, k, v)))
    got = torch.cat([r["sp"][(causal, kvh)] for r in ranks], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gpipe_equals_jax(ranks):
    stages, x = _gpipe_inputs()
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in st.items()}
                                  for st in stages])
    fn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
    want = jax.jit(lambda sp, xs: gpipe_apply(fn, sp, xs, _mesh("stage"),
                                              "stage"))(stacked, jnp.asarray(x))
    for res in ranks:
        assert res["gpipe"].shape == want.shape
        np.testing.assert_allclose(res["gpipe"].numpy(), np.asarray(want),
                                   atol=1e-5)


def test_gpipe_llama_blocks_by_stage(llama, ranks):
    cfg, params, ref = llama
    p = params["params"]
    stacked = stack_stage_params([p[f"layer_{i}"] for i in range(cfg.layers)])
    block = JBlock(cfg)
    k0 = jnp.zeros((1, 8, cfg.kv_heads, cfg.head_dim), jnp.float32)
    fn = lambda bp, x: block.apply({"params": bp}, x, k0, k0, 0,
                                   TOKS.shape[1])[0]
    emb = p["embed_tokens"]["embedding"][jnp.asarray(TOKS)]
    h = gpipe_apply(fn, stacked, emb[None], _mesh("stage"), "stage")[0]
    hn = JRMSNorm(cfg.rms_eps, cfg.norm_plus_one).apply({"params": p["norm"]},
                                                        h)
    want = np.asarray(hn @ p["lm_head"]["kernel"])
    for res in ranks:
        got = res["llama_logits"].numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)
        np.testing.assert_allclose(got, ref, atol=2e-4)
