"""The port's batched caption decode held against the JAX package at tiny
geometry, fp32 on the CPU: `generate_batch` gives JAX's ids for three
prompts whose lengths straddle a `pad_to` bucket, greedy and sampled at
T = 0.2 with JAX's [B, vocab] Gumbel draws, on dense, int8 and int4
decoders, with a row that ends early; one prompt gives `generate`'s ids;
the lm_head on each row's last position equals the full logits there;
`LlavaCaptioner.caption_batch` gives JAX's strings; the B-row decode step
reads nothing on the host; a kept loop state serves a second batch."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.models.vlm import generate as jgen
from rsvldm_tpu.models.vlm.captioner import LlavaCaptioner as JCaptioner
from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu_torch.config import LlavaConfig
from rsvldm_tpu_torch.models.vlm import generate as tgen
from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
from rsvldm_tpu_torch.models.vlm.llama import KVCache
from torch_parity_lib import randomize, to_np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graphs import GuardedRunner  # noqa: E402
from test_torch_vlm import JL, JV, TL, TV, FakeTokenizer, _models  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(9)
LENS = (6, 9, 13)  # pad_to 8: one prompt below the bucket, two above


@pytest.fixture(scope="module")
def llama_tree():
    jm = JLlama(JL)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(JL, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, 31))


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((s, 32)) * 0.5).astype(np.float32) for s in lens]


def _jax_gumbel_rows(rng, rows, vocab):
    """JAX generate_batch's draw for token i, [rows, vocab]: `rng` for the
    first, fold_in(rng, i) after (categorical over axis -1)."""
    def draw(i):
        key = rng if i == 0 else jax.random.fold_in(rng, i)
        return torch.tensor(np.asarray(
            jax.random.gumbel(key, (rows, vocab), jnp.float32)))
    return draw


def _both(tree, mode, prompts, rng, **kw):
    """(JAX generate_batch ids, the port's, the port's stats)."""
    jm, jp, tm = _models(tree, mode)
    want = jgen.generate_batch(jm, jp, [jnp.asarray(p) for p in prompts],
                               jgen.GenerateConfig(**kw), rng)
    stats = {}
    got = tgen.generate_batch(tm, [torch.from_numpy(p) for p in prompts],
                              tgen.GenerateConfig(**kw),
                              noise=_jax_gumbel_rows(rng, len(prompts),
                                                     TL.vocab_size),
                              stats=stats)
    return want, got, stats


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("sampled", [False, True])
def test_generate_batch_ids_equal_jax(llama_tree, mode, sampled):
    """Three prompts of 6, 9 and 13 positions in one 16-position bucket,
    20 new tokens (past a done-flag window): JAX's ids row by row."""
    rng = jax.random.PRNGKey(4)
    kw = dict(max_new_tokens=20, temperature=0.2, do_sample=sampled, pad_to=8)
    want, got, stats = _both(llama_tree, mode, _prompts(), rng, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["prompt_lens"] == list(LENS) and stats["padded_len"] == 16
    assert stats["rows"] == 3 and stats["decode_steps"] == 19
    assert all(len(g) == 20 for g in got)


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_batch_row_ends_early(llama_tree, sampled):
    """The eot id made a token JAX draws in row 1 at position j (5 or
    later, where it does not occur before in that row): row 1 is trimmed
    there, every row equals JAX's, and the loop runs on for the others."""
    rng = jax.random.PRNGKey(12)
    kw = dict(max_new_tokens=20, temperature=0.2, do_sample=sampled, pad_to=8)
    jm, jp, _ = _models(llama_tree, "int4")
    prompts = _prompts(seed=1)
    ids = jgen.generate_batch(jm, jp, [jnp.asarray(p) for p in prompts],
                              jgen.GenerateConfig(**kw), rng)
    row = ids[1]
    j = next(j for j in range(5, 15) if row[j] not in row[:j])
    kw["eot_ids"] = (int(row[j]),)
    want, got, stats = _both(llama_tree, "int4", prompts, rng, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], row[:j])
    assert len(got[1]) < max(len(g) for g in got)


def test_generate_batch_one_prompt_is_generate(llama_tree):
    """B = 1 runs `generate`, as JAX's generate_batch does."""
    jm, jp, tm = _models(llama_tree, "int4")
    p = _prompts(lens=(11,))[0]
    rng = jax.random.PRNGKey(2)
    kw = dict(max_new_tokens=8, temperature=0.2, do_sample=True, pad_to=8)
    want = jgen.generate_batch(jm, jp, [jnp.asarray(p)], jgen.GenerateConfig(**kw), rng)
    noise = _jax_gumbel_rows(rng, 1, TL.vocab_size)
    got = tgen.generate_batch(tm, [torch.from_numpy(p)], tgen.GenerateConfig(**kw),
                              noise=noise)
    single = tgen.generate(tm, torch.from_numpy(p), tgen.GenerateConfig(**kw),
                           noise=noise)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], single)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_lm_head_rows_equal_full_logits(llama_tree, mode):
    """The batched prefill's lm_head on each row's last real position
    (`logits_at`) gives the full logits' values there, bit for bit: every
    op after the last block is per token."""
    _, _, tm = _models(llama_tree, mode)
    x = torch.from_numpy(np.stack([np.pad(p, ((0, 16 - len(p)), (0, 0)))
                                   for p in _prompts()]))
    at = torch.tensor(LENS) - 1
    with torch.inference_mode():
        full, _ = tm(x, KVCache.init(TL, 3, 16), 0)
        rows, _ = tm(x, KVCache.init(TL, 3, 16), 0, logits_at=at)
    assert rows.shape == (3, 1, TL.vocab_size)
    assert torch.equal(rows[:, 0], full[torch.arange(3), at])


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_batched_decode_step_has_no_host_read(llama_tree, mode, monkeypatch):
    """The B-row decode step (sampled and greedy) under the dispatch mode
    of tests/test_torch_graphs.py that refuses host reads."""
    monkeypatch.setattr(tgen, "StepRunner", GuardedRunner)
    GuardedRunner.ran = []
    _, _, tm = _models(llama_tree, mode)
    prompts = [torch.from_numpy(p) for p in _prompts()]
    for sample in (True, False):
        cfg = tgen.GenerateConfig(max_new_tokens=20, do_sample=sample,
                                  eot_ids=(1000,), pad_to=8)
        ids = tgen.generate_batch(tm, prompts, cfg)
        assert [len(i) for i in ids] == [20, 20, 20]
    assert GuardedRunner.ran == ["<lambda>"] * 38


def test_generate_batch_reuses_its_state(llama_tree):
    """A graph cache keeps one loop state per (bucket, rows): a second batch
    of other prompts in the same bucket reuses it (over the first batch's
    cache) and gets a fresh call's ids; one prompt of 6 keeps its own."""
    _, _, tm = _models(llama_tree, "int4")
    cfg = tgen.GenerateConfig(max_new_tokens=12, do_sample=False, pad_to=8)
    batches = [[torch.from_numpy(p) for p in _prompts(seed=s)] for s in (3, 4)]
    batches.append(batches[0][:1])
    cache: dict = {}
    got = [tgen.generate_batch(tm, b, cfg, graph_cache=cache) for b in batches]
    fresh = [tgen.generate_batch(tm, b, cfg) for b in batches]
    for a, b in zip(got, fresh):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sorted((k[0], k[-1]) for k in cache) == [(8, 1), (16, 3)]


# -------------------------------------------------------------- captioner
@pytest.fixture(scope="module")
def captioners(tmp_path_factory):
    """tests/test_captioner.py's tiny LLaVA state dict, read by the JAX
    loader from safetensors and by from_state_dict; int4 decoder."""
    from safetensors.torch import save_file
    import test_captioner
    sd = test_captioner._tiny_llava_state_dict()
    d = tmp_path_factory.mktemp("batch_caption")
    (d / "llava").mkdir()
    save_file(sd, str(d / "llava" / "model.safetensors"))
    jcap = JCaptioner.load(d, llama_cfg=JL, vision_cfg=JV,
                           tokenizer=FakeTokenizer(), quant="int4")
    tcap = LlavaCaptioner.from_state_dict(sd, TL, TV, FakeTokenizer(),
                                          quant="int4", device="cpu")
    return jcap, tcap


def _images():
    return [Image.fromarray(RNG.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in ((50, 70), (60, 60), (40, 90))]


@pytest.mark.parametrize("sampled", [False, True])
def test_caption_batch_strings_equal_jax(captioners, sampled):
    """Three images of different shapes (different image-token counts): JAX
    caption_batch's strings, greedy and sampled at T = 0.2 with JAX's
    draws from its default key; the stats name the rows' prompt lengths."""
    jcap, tcap = captioners
    imgs = _images()
    kw = dict(max_new_tokens=10, temperature=0.2, do_sample=sampled)
    want = jcap.caption_batch(imgs, LlavaConfig(**kw))
    got = tcap.caption_batch(imgs, LlavaConfig(**kw), noise=_jax_gumbel_rows(
        jax.random.PRNGKey(0), 3, TL.vocab_size))
    assert got == want and any(got)
    st = tcap.last_stats
    assert st["rows"] == 3 and len(set(st["prompt_lens"])) > 1
    assert st["decode_steps"] <= 9 and st["prefill_s"] >= 0


def test_caption_batch_of_one_is_caption(captioners):
    """One image: caption_batch gives `caption`'s string (generate's ids),
    as JAX's does."""
    jcap, tcap = captioners
    img = _images()[1]
    lcfg = LlavaConfig(max_new_tokens=8, temperature=0.0, do_sample=False)
    got = tcap.caption_batch([img], lcfg)
    assert got == [tcap.caption(img, lcfg)] == jcap.caption_batch([img], lcfg)
