"""Speculative caption decoding of the port (models/vlm/speculative.py) held
against the JAX package's (rsvldm_tpu/models/vlm/speculative.py) at tiny
geometry, fp32 on the CPU, with the same weights, and for sampling the
same key: the port draws JAX's Gumbel, acceptance uniform and resample
Gumbel per generated index from the key itself (utils/prng.py), with
nothing injected. The contracts of
tests/test_speculative.py: greedy ids equal JAX's `generate` for a weak
draft and for the self-draft; draft == target at T = 0.8 gives JAX's
sampled ids; a weak draft at T = 0.8 gives JAX's speculative ids and
stats; `accept_and_correct` gives JAX's committed tokens and count on
seeded distributions; the eot and max_new_tokens bounds; dense and int4
targets. Then the round has no host read (it is captured as a CUDA graph
on the card), the self-draft shares the target's modules, and the loop
kept in a graph cache is reused. And the captioner: <ckpt_dir>/llava_draft
found and used (the captions JAX's), a draft equal to the target keeping
the sampled caption, the self-draft from `load`, the refusals of a
draft of another width or vocabulary and of a named draft directory
without weights, a draft with a tied lm_head, and a self-draft carrying
the target's LoRA adapters, as JAX's."""

import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.config import LlavaConfig as JLlavaConfig
from rsvldm_tpu.models.vlm import speculative as jspec
from rsvldm_tpu.models.vlm.captioner import LlavaCaptioner as JCaptioner
from rsvldm_tpu.models.vlm.generate import GenerateConfig as JGenerateConfig
from rsvldm_tpu.models.vlm.generate import generate as jgenerate
from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.llama import quantize_llama_params
from rsvldm_tpu_torch.config import LlavaConfig as TLlavaConfig
from rsvldm_tpu_torch.models.vlm import generate as tgen
from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
from rsvldm_tpu_torch.models.vlm import speculative as tspec
from rsvldm_tpu_torch.models.vlm.llama import (LlamaConfig, LlamaModel,
                                               quantize_llama_)
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
from rsvldm_tpu_torch.utils import prng
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import randomize, to_np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_captioner as tc  # noqa: E402
from test_torch_graphs import GuardedRunner  # noqa: E402


class GuardedRounds(GuardedRunner):
    replays = 0

torch.set_num_threads(1)
# tests/test_speculative.py's CFG; the weak draft has one layer and other
# weights
_L = dict(vocab_size=96, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
JL, TL = JLlamaConfig(**_L), LlamaConfig(**_L)
GREEDY = dict(max_new_tokens=14, temperature=0.0, do_sample=False,
              eot_ids=(95,), pad_to=8)
SAMPLED = dict(GREEDY, temperature=0.8, do_sample=True)
# tests/test_captioner.py's LCFG / VCFG in the port's classes
CAP_L = LlamaConfig(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2,
                    ffn_dim=64)
CAP_V = CLIPVisionConfig(image_size=28, patch_size=14, width=24, layers=2,
                         heads=2, select_layer=-2)


def _tree(cfg, seed):
    """Randomized weights with the lm_head scaled up: logits of about unit
    spread, so that at T = 0.8 a weak draft's proposals are rejected at
    times (randomize's scale gives nearly flat distributions)."""
    jm = JLlama(cfg)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(cfg, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    tree = to_np(randomize(shapes, seed))
    tree["params"]["lm_head"]["kernel"] = tree["params"]["lm_head"]["kernel"] * 12
    return tree


def _pair(tree, jcfg, tcfg, mode):
    """(JAX model, its params, the port's model) with the same weights,
    dense or quantized alike."""
    port = LlamaModel(tcfg)
    port.load_state_dict(params_from_jax("llama", tree, tcfg), strict=True)
    port.eval().requires_grad_(False)
    if mode is None:
        return JLlama(jcfg), tree, port
    qtree = {"params": quantize_llama_params(tree["params"],
                                             embed_dtype=jnp.bfloat16, mode=mode)}
    return (JLlama(dataclasses.replace(jcfg, quant=mode)), qtree,
            quantize_llama_(port, mode))


@pytest.fixture(scope="module")
def trees():
    weak = dataclasses.replace(JL, layers=1)
    return _tree(JL, 31), _tree(weak, 32)


def _models(trees, mode):
    target = _pair(trees[0], JL, TL, mode)
    weak = _pair(trees[1], dataclasses.replace(JL, layers=1),
                 dataclasses.replace(TL, layers=1), mode)
    return target, weak


def _prompt(s, seed):
    return (np.random.default_rng(seed).standard_normal((s, 32)) * 0.5
            ).astype(np.float32)


def _pkey(rng) -> tuple:
    """The port's key (utils/prng.py) for a JAX PRNGKey."""
    return tuple(int(v) for v in np.asarray(rng))


def _run(t_model, d_model, emb, kw, rng=None, k=3, **extra):
    stats = {}
    ids = tspec.speculative_generate(
        t_model, d_model, torch.from_numpy(np.asarray(emb)),
        tgen.GenerateConfig(**kw), k=k,
        key=None if rng is None else _pkey(rng), stats=stats, **extra)
    return ids, stats


@pytest.mark.parametrize("mode", [None, "int4"])
def test_greedy_equals_jax_generate_weak_draft(trees, mode):
    """A weak draft (one layer, other weights): the greedy ids are JAX's
    `generate` ids, for three prompts, k = 3."""
    (jm, jp, tm), (_, _, dm) = _models(trees, mode)
    for seed in (3, 4, 5):
        emb = _prompt(5 + seed, seed)
        want = jgenerate(jm, jp, jnp.asarray(emb), JGenerateConfig(**GREEDY),
                         jax.random.PRNGKey(9))
        got, st = _run(tm, dm, emb, GREEDY)
        np.testing.assert_array_equal(got, want)
        assert st["rounds"] > 0 and st["proposed"] == 3 * st["rounds"]


@pytest.mark.parametrize("mode", [None, "int4"])
def test_self_draft_greedy_equals_jax(trees, mode):
    """The target's first layer as the draft: greedy ids equal JAX's
    `generate` and JAX's speculative run with its own self-draft, with the
    same acceptance counts."""
    (jm, jp, tm), _ = _models(trees, mode)
    emb = _prompt(6, 11)
    want = jgenerate(jm, jp, jnp.asarray(emb), JGenerateConfig(**GREEDY),
                     jax.random.PRNGKey(4))
    jdm, jdp = jspec.self_draft(jp, jm.cfg, layers=1)
    jids, jst = jspec.speculative_generate(
        jm, jp, jdm, jdp, jnp.asarray(emb), JGenerateConfig(**GREEDY),
        jax.random.PRNGKey(4), k=3, return_stats=True)
    got, st = _run(tm, tspec.self_draft(tm, 1), emb, GREEDY)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jids)
    assert {k: st[k] for k in jst} == jst


@pytest.mark.parametrize("mode", [None, "int4"])
def test_draft_equals_target_reproduces_jax_sampled_ids(trees, mode):
    """draft == target at T = 0.8 from JAX's key: every proposal is kept,
    and the ids are JAX's speculative ids and JAX's `generate` ids."""
    (jm, jp, tm), _ = _models(trees, mode)
    emb = _prompt(7, 21)
    rng = jax.random.PRNGKey(2)
    want = jgenerate(jm, jp, jnp.asarray(emb), JGenerateConfig(**SAMPLED), rng)
    jids = jspec.speculative_generate(jm, jp, jm, jp, jnp.asarray(emb),
                                      JGenerateConfig(**SAMPLED), rng, k=4)
    got, st = _run(tm, tm, emb, SAMPLED, rng, k=4)
    np.testing.assert_array_equal(jids, want)
    np.testing.assert_array_equal(got, want)
    assert st["accept_rate"] == 1.0


@pytest.mark.parametrize("mode", [None, "int4"])
def test_weak_draft_sampled_ids_and_stats_equal_jax(trees, mode):
    """A weak draft at T = 0.8 from JAX's key, nothing injected: JAX's
    speculative ids and its rounds, proposals, acceptances and rate
    (proposals rejected and resampled on the way, which greedy never
    exercises)."""
    (jm, jp, tm), (jdm, jdp, dm) = _models(trees, mode)
    for seed, rng in ((13, jax.random.PRNGKey(6)), (14, jax.random.PRNGKey(7))):
        emb = _prompt(8, seed)
        jids, jst = jspec.speculative_generate(
            jm, jp, jdm, jdp, jnp.asarray(emb), JGenerateConfig(**SAMPLED),
            rng, k=3, return_stats=True)
        got, st = _run(tm, dm, emb, SAMPLED, rng, k=3)
        np.testing.assert_array_equal(got, jids)
        assert {k: st[k] for k in jst} == jst
        assert 0.0 < st["accept_rate"] < 1.0


def test_accept_and_correct_equals_jax():
    """Seeded distributions (softmax of random logits at several spreads,
    and one draft equal to the target): committed tokens and their count
    equal JAX's for k = 4 at j0 = 5, the port's tables drawn as
    speculative_generate draws them from the same key (default_accept_noise
    and the proposal Gumbel of fold_in(key, j0 + k) for the bonus)."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(17)
    k, vocab, j0 = 4, 96, 5
    u, resample = torch.zeros(j0 + k), torch.zeros((j0 + k, vocab))
    tspec.default_accept_noise(_pkey(key), u, resample)
    u, resample = u[j0:], resample[j0:]
    bonus = prng.gumbel(prng.fold_in(_pkey(key), j0 + k), (vocab,))
    seen = set()
    for case in range(12):
        spread = (0.5, 2.0, 6.0)[case % 3]
        t_logits = rng.standard_normal((k + 1, vocab)).astype(np.float32) * spread
        d_logits = (t_logits[:k] if case == 11 else
                    rng.standard_normal((k, vocab)).astype(np.float32) * spread)
        t_d = jax.nn.softmax(jnp.asarray(t_logits), -1)
        d_d = jax.nn.softmax(jnp.asarray(d_logits), -1)
        d_toks = jnp.argmax(d_logits + rng.gumbel(size=d_logits.shape), -1
                            ).astype(jnp.int32)
        jc, jn = jspec.accept_and_correct(
            d_toks, d_d, t_d, lambda i: jax.random.fold_in(key, j0 + i), k)
        tc, tn = tspec.accept_and_correct(
            torch.from_numpy(np.array(d_toks)).long(),
            torch.from_numpy(np.array(d_d)), torch.from_numpy(np.array(t_d)),
            u, resample, bonus)
        n = int(jn)
        assert int(tn) == n
        np.testing.assert_array_equal(tc.numpy()[:n], np.asarray(jc)[:n])
        seen.add(n)
    assert len(seen) >= 3 and k + 1 in seen  # rejections and a full accept


@pytest.mark.parametrize("sampled", [False, True])
def test_eot_truncation_equals_jax(trees, sampled):
    """A token that occurs mid-stream made the eot: both packages trim
    before it (greedy, and at T = 0.8 with JAX's draws)."""
    (jm, jp, tm), (jdm, jdp, dm) = _models(trees, None)
    emb = _prompt(6, 41)
    kw = SAMPLED if sampled else GREEDY
    rng = jax.random.PRNGKey(1)
    base = jspec.speculative_generate(jm, jp, jdm, jdp, jnp.asarray(emb),
                                      JGenerateConfig(**kw), rng, k=3)
    j = next(j for j in range(3, 10) if base[j] not in base[:j])
    kw = dict(kw, eot_ids=(int(base[j]),))
    want = jspec.speculative_generate(jm, jp, jdm, jdp, jnp.asarray(emb),
                                      JGenerateConfig(**kw), rng, k=3)
    got, _ = _run(tm, dm, emb, kw, rng if sampled else None)
    np.testing.assert_array_equal(got, want)
    assert len(got) == j


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_max_new_tokens_bound_equals_jax(trees, max_new):
    (jm, jp, tm), (jdm, jdp, dm) = _models(trees, None)
    emb = _prompt(9, 51)
    kw = dict(GREEDY, max_new_tokens=max_new)
    want = jspec.speculative_generate(jm, jp, jdm, jdp, jnp.asarray(emb),
                                      JGenerateConfig(**kw),
                                      jax.random.PRNGKey(4), k=3)
    got, _ = _run(tm, dm, emb, kw)
    np.testing.assert_array_equal(got, want)
    assert len(got) == max_new


def test_self_draft_shares_the_target(trees):
    """The self-draft is the target's own modules (no copy), its forward a
    one-layer model's over the same weights; its depth must be below the
    target's."""
    (_, _, tm), _ = _models(trees, None)
    dm = tspec.self_draft(tm, 1)
    assert dm.cfg.layers == 1 and len(dm.model.layers) == 1
    assert dm.model.layers[0] is tm.model.layers[0]
    assert dm.lm_head is tm.lm_head and dm.model.embed_tokens is tm.model.embed_tokens
    one = LlamaModel(dataclasses.replace(TL, layers=1))
    sd = {k: v for k, v in tm.state_dict().items() if ".layers.1." not in k}
    one.load_state_dict(sd, strict=True)
    x = torch.from_numpy(_prompt(5, 2))[None]
    with torch.inference_mode():
        np.testing.assert_array_equal(dm(x)[0].numpy(), one(x)[0].numpy())
    for bad in (0, 2):
        with pytest.raises(ValueError, match="self-draft layers"):
            tspec.self_draft(tm, bad)


@pytest.mark.parametrize("sampled", [False, True])
def test_round_has_no_host_read(trees, monkeypatch, sampled):
    """Every round runs under a dispatch mode that refuses host reads
    (tests/test_torch_graphs.py), int4 target and draft: the round is one
    device program, replayable from a CUDA graph."""
    (_, _, tm), (_, _, dm) = _models(trees, "int4")
    monkeypatch.setattr(tspec, "StepRunner", GuardedRounds)
    GuardedRunner.ran = []
    got, st = _run(tm, dm, _prompt(6, 3), SAMPLED if sampled else GREEDY,
                   jax.random.PRNGKey(0) if sampled else None)
    assert len(GuardedRunner.ran) == st["rounds"] > 0


def test_kept_loop_is_reused(trees):
    """A graph cache keeps one loop state per bucket: a second prompt of
    the same bucket reuses it over the first's cache contents and gets a
    fresh call's ids; the default sampled stream is seeded."""
    (_, _, tm), (_, _, dm) = _models(trees, None)
    prompts = [torch.from_numpy(_prompt(s, s)) for s in (7, 5)]
    cfg = tgen.GenerateConfig(**SAMPLED)
    cache: dict = {}
    kept = [tspec.speculative_generate(tm, dm, p, cfg, 3, graph_cache=cache)
            for p in prompts]
    fresh = [tspec.speculative_generate(tm, dm, p, cfg, 3) for p in prompts]
    for a, b in zip(kept, fresh):
        np.testing.assert_array_equal(a, b)
    assert len(cache) == 1


# -------------------------------------------------------------- captioner
def _llava_dir(root):
    """<root>/llava: tests/test_captioner.py's tiny LLaVA state dict."""
    from safetensors.torch import save_file
    (root / "llava").mkdir()
    save_file(tc._tiny_llava_state_dict(), str(root / "llava" / "model.safetensors"))
    return root


def _write_config(dd, **over):
    """A draft directory with a config.json of the tiny geometry, `over`
    applied, and a one-tensor shard: the geometry checks run before the
    weights are read."""
    from safetensors.torch import save_file
    dd.mkdir()
    cfg = {"vocab_size": 256, "hidden_size": 32, "num_hidden_layers": 1,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 64, **over}
    (dd / "config.json").write_text(json.dumps(cfg))
    save_file({"lm_head.weight": torch.zeros(1)}, str(dd / "model.safetensors"))
    return dd


def _load_both(root, **kw):
    """(JAX captioner, port captioner) of root at tests/test_captioner.py's
    geometry."""
    j = JCaptioner.load(root, llama_cfg=tc.LCFG, vision_cfg=tc.VCFG,
                        tokenizer=tc.FakeTokenizer(), **kw)
    t = LlavaCaptioner.load(root, llama_cfg=CAP_L, vision_cfg=CAP_V,
                            tokenizer=tc.FakeTokenizer(), device="cpu", **kw)
    return j, t


def _image(seed, h=40, w=56):
    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (h, w, 3), dtype=np.uint8))


def test_auto_detected_draft_caption_equals_jax(tmp_path):
    """<ckpt_dir>/llava_draft (a one-layer checkpoint with its config.json)
    is found by both packages; greedy, the port's speculative caption is
    JAX's and the vanilla one; with draft_dir=False neither loads it."""
    root = _llava_dir(tmp_path)
    lcfg = TLlavaConfig(max_new_tokens=8, temperature=0.0, do_sample=False)
    jlcfg = JLlavaConfig(max_new_tokens=8, temperature=0.0, do_sample=False)
    img = _image(6)
    _, vanilla = _load_both(root)
    ref = vanilla.caption(img, lcfg)
    tc._write_draft_dir(root, layers=1)
    jcap, tcap = _load_both(root, spec_k=3)
    assert tcap.draft is not None and tcap.draft.cfg.layers == 1
    assert tcap.spec_k == 3 and tcap.self_draft_layers == 0
    assert tcap.caption(img, lcfg) == jcap.caption(img, jlcfg) == ref
    assert tcap.last_stats["rounds"] > 0
    off = LlavaCaptioner.load(root, llama_cfg=CAP_L, vision_cfg=CAP_V,
                              tokenizer=tc.FakeTokenizer(), draft_dir=False,
                              device="cpu")
    assert off.draft is None


def test_draft_equal_to_target_keeps_the_sampled_caption(tmp_path):
    """A draft checkpoint equal to the target (both layers), at T = 0.7
    with the default draws: every proposal is kept and the caption is the
    vanilla sampled caption (the proposal draws are `generate`'s)."""
    root = _llava_dir(tmp_path)
    lcfg = TLlavaConfig(max_new_tokens=8, temperature=0.7, do_sample=True)
    img = _image(5, 50, 70)
    _, vanilla = _load_both(root)
    ref = vanilla.caption(img, lcfg)
    tc._write_draft_dir(root, layers=2)
    cap = LlavaCaptioner.load(root, llama_cfg=CAP_L, vision_cfg=CAP_V,
                              tokenizer=tc.FakeTokenizer(), device="cpu")
    assert cap.draft.cfg.layers == 2
    assert cap.caption(img, lcfg) == ref
    assert cap.last_stats["accept_rate"] == 1.0


def test_self_draft_from_load(tmp_path):
    """self_draft_layers without a draft checkpoint: the target's first
    layer, shared, and the greedy caption of JAX's self-draft captioner."""
    root = _llava_dir(tmp_path)
    jcap, tcap = _load_both(root, self_draft_layers=1)
    assert tcap.self_draft_layers == 1
    assert tcap.draft.model.layers[0] is tcap.llama.model.layers[0]
    img = _image(7)
    assert tcap.caption(img, TLlavaConfig(max_new_tokens=8, temperature=0.0,
                                          do_sample=False)) == \
        jcap.caption(img, JLlavaConfig(max_new_tokens=8, temperature=0.0,
                                       do_sample=False))


@pytest.mark.parametrize("over,err,match", [
    (dict(hidden_size=48), ValueError, "draft hidden dim 48 != target 32"),
    (dict(vocab_size=300), ValueError, "draft vocab 300 != target 256"),
])
def test_mismatched_draft_raises_as_jax(tmp_path, over, err, match):
    root = _llava_dir(tmp_path)
    dd = _write_config(tmp_path / "d", **over)
    for load, cfgs in ((JCaptioner.load, (tc.LCFG, tc.VCFG)),
                       (functools.partial(LlavaCaptioner.load, device="cpu"),
                        (CAP_L, CAP_V))):
        with pytest.raises(err, match=match):
            load(root, llama_cfg=cfgs[0], vision_cfg=cfgs[1],
                 tokenizer=tc.FakeTokenizer(), draft_dir=str(dd))


@pytest.mark.parametrize("what", ["missing", "empty"])
def test_named_draft_dir_without_weights_raises_as_jax(tmp_path, what):
    root = _llava_dir(tmp_path)
    dd = tmp_path / "draft"
    if what == "empty":
        dd.mkdir()
    match = "does not exist" if what == "missing" else "contains no safetensors"
    for load, cfgs in ((JCaptioner.load, (tc.LCFG, tc.VCFG)),
                       (functools.partial(LlavaCaptioner.load, device="cpu"),
                        (CAP_L, CAP_V))):
        with pytest.raises(FileNotFoundError, match=match):
            load(root, llama_cfg=cfgs[0], vision_cfg=cfgs[1],
                 tokenizer=tc.FakeTokenizer(), draft_dir=str(dd))


def _write_tied_draft(root):
    """<root>/llava_draft: tests/test_captioner.py's one-layer draft with its
    lm_head tied to the embedding (tie_word_embeddings, no lm_head.weight)."""
    from safetensors.torch import load_file, save_file
    dd = tc._write_draft_dir(root, layers=1)
    sd = load_file(str(dd / "model.safetensors"))
    del sd["lm_head.weight"]
    save_file(sd, str(dd / "model.safetensors"))
    cfg = json.loads((dd / "config.json").read_text())
    (dd / "config.json").write_text(json.dumps(dict(cfg, tie_word_embeddings=True)))
    return dd


def test_tied_lm_head_draft_equals_jax(tmp_path):
    """A draft whose config.json ties its lm_head to the embedding loads as
    JAX's does (logits x @ embedding^T): its prefill logits equal JAX's
    draft's within 1e-5, and at T = 0.8 from JAX's key, the speculative
    caption is JAX's (the proposals come from the tied head)."""
    root = _llava_dir(tmp_path)
    _write_tied_draft(root)
    jcap, tcap = _load_both(root, spec_k=3)
    assert tcap.draft.cfg.tie_lm_head and tcap.draft.lm_head is None
    assert "lm_head.weight" not in tcap.draft.state_dict()
    emb = _prompt(9, 17)
    jlog, _ = jcap.draft.apply(jcap.draft_params, jnp.asarray(emb)[None],
                               JKVCache.init(jcap.draft.cfg, 1, 9), 0)
    with torch.inference_mode():
        tlog, _ = tcap.draft(torch.from_numpy(emb)[None])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-5)
    rng = jax.random.PRNGKey(12)
    img = _image(8)
    want = jcap.caption(img, JLlavaConfig(max_new_tokens=10, temperature=0.8,
                                          do_sample=True), rng)
    got = tcap.caption(img, TLlavaConfig(max_new_tokens=10, temperature=0.8,
                                         do_sample=True), key=_pkey(rng))
    assert got == want and tcap.last_stats["rounds"] > 0


def test_lora_self_draft_sampled_caption_equal_jax(tmp_path, monkeypatch):
    """int4 target with a JAX-written LoRA archive and a one-layer
    self-draft, at T = 0.8 from JAX's key: the caption is JAX's, whose
    self-draft keeps layer 0's adapters; a self-draft run without them
    gives another caption (the adapters reach the draft)."""
    from rsvldm_tpu.training.vlm_trainer import (LoraConfig as JLoraConfig,
                                                 save_lora_npz)
    from rsvldm_tpu_torch.models.vlm import captioner as tcm
    root = _llava_dir(tmp_path)
    rng = np.random.default_rng(19)
    lora = {f"layer_{i}": {p: {"a": rng.standard_normal((din, 4), np.float32) * 0.5,
                               "b": rng.standard_normal((4, dout), np.float32) * 0.5}
                           for p, din, dout in (("q_proj", 32, 32), ("o_proj", 32, 32),
                                                ("gate_proj", 32, 64),
                                                ("down_proj", 64, 32))}
            for i in range(2)}
    save_lora_npz(lora, JLoraConfig(r=4, alpha=8), tmp_path / "lora.npz")
    jcap, tcap = _load_both(root, quant="int4", lora_npz=tmp_path / "lora.npz",
                            self_draft_layers=1, spec_k=3)
    assert tcap.lora is not None and tcap.self_draft_layers == 1
    key = jax.random.PRNGKey(5)
    img = _image(9)
    kw = dict(max_new_tokens=16, temperature=0.8, do_sample=True)
    want = jcap.caption(img, JLlavaConfig(**kw), key)
    got = tcap.caption(img, TLlavaConfig(**kw), key=_pkey(key))
    assert got == want and 0.0 < tcap.last_stats["accept_rate"] < 1.0
    spec = tcm.speculative_generate
    monkeypatch.setattr(tcm, "speculative_generate",
                        lambda *a, draft_lora=None, **k: spec(*a, **k))
    bare = tcap.caption(img, TLlavaConfig(**kw), key=_pkey(key))
    assert bare != got
