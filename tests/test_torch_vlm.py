"""The port's caption stage held against the JAX package at tiny geometry,
fp32 on the CPU: CLIP vision tower, projector, anyres assembly (and its
anyres_max_N downscale), the conversation templates, the Llama
decoder (dense, int8, int4: prefill and decode logits, KV caches, greedy
ids, sampled ids with JAX's Gumbel noise), the whole captioner from one HF-named state dict and from a
checkpoint directory (two shards, a PEFT adapter, tokenizer.json; LoRA and
projector archives written by JAX), and the JAX tree -> port -> JAX
converter round trips."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.models.vlm import anyres as janyres
from rsvldm_tpu.models.vlm import generate as jgen
from rsvldm_tpu.models.vlm.captioner import LlavaCaptioner as JCaptioner
from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.llama import quantize_llama_params
from rsvldm_tpu.models.vlm.projector import MLPProjector as JProjector
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
from rsvldm_tpu.models.vlm.vision import CLIPVisionTower as JTower
from rsvldm_tpu.utils import convert_hf
from rsvldm_tpu_torch.config import LlavaConfig
from rsvldm_tpu_torch.models.vlm import anyres
from rsvldm_tpu_torch.models.vlm import generate as tgen
from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
from rsvldm_tpu_torch.models.vlm.llama import (KVCache, LlamaConfig,
                                               LlamaModel, quantize_llama_)
from rsvldm_tpu_torch.models.vlm.projector import MLPProjector
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig, CLIPVisionTower
from rsvldm_tpu_torch.utils.weights import llava_from_jax, params_from_jax
from torch_parity_lib import assert_close, japply, randomize, to_np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
# tests/test_captioner.py's LCFG / VCFG
_L = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
_V = dict(image_size=28, patch_size=14, width=24, layers=2, heads=2,
          select_layer=-2)
JL, TL = JLlamaConfig(**_L), LlamaConfig(**_L)
JV, TV = JVisionConfig(**_V), CLIPVisionConfig(**_V)


class FakeTokenizer:
    """tests/test_captioner.py's stand-in: characters as ids."""

    def encode(self, s, add_special_tokens=False):
        return [min(ord(c), 250) for c in s[:40]]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(max(i, 32) % 127) for i in ids if i < 250)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval().requires_grad_(False)


# ------------------------------------------------------- tower, projector
@pytest.fixture(scope="module")
def vision():
    jm = JTower(JV)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 28, 28, 3))), 21))
    return jm, tree, _load(CLIPVisionTower(TV), params_from_jax("clip_vision", tree, TV))


def test_clip_vision_tower(vision):
    jm, tree, tm = vision
    px = RNG.standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = japply(jm, tree, jnp.asarray(px))
    got = tm(torch.from_numpy(px))
    assert got.shape == (2, 4, 24)
    assert_close(got.numpy(), want)


def test_projector():
    jm = JProjector(out_dim=32)
    x = RNG.standard_normal((2, 4, 24)).astype(np.float32)
    tree = to_np(randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), 22))
    tm = _load(MLPProjector(24, 32), params_from_jax("projector", tree, None))
    assert_close(tm(torch.from_numpy(x)).numpy(), japply(jm, tree, jnp.asarray(x)))


# ----------------------------------------------------------------- anyres
@pytest.mark.parametrize("size", [(50, 50), (50, 70), (90, 40)])
def test_anyres_assembly_equal(size):
    img = Image.fromarray(RNG.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    grid = anyres.grid_pinpoints_for(28)
    assert grid == janyres.grid_pinpoints_for(28)
    got = anyres.process_anyres_image(img, 28, grid)
    np.testing.assert_array_equal(got, janyres.process_anyres_image(img, 28, grid))
    feats = RNG.standard_normal((got.shape[0], 4, 6)).astype(np.float32)
    newline = RNG.standard_normal(6).astype(np.float32)
    want = janyres.assemble_spatial_unpad(feats, img.size, newline, grid, 28)
    tokens = anyres.assemble_spatial_unpad(feats, img.size, newline, grid, 28)
    np.testing.assert_array_equal(tokens, want)


@pytest.mark.parametrize("size,max_n,shrinks", [
    ((672, 672), 1, True), ((672, 672), 3, True), ((672, 336), 1, True),
    ((500, 900), 1, True), ((336, 1008), 2, True), ((672, 672), 9, False),
    ((500, 900), 2, False)])
def test_assemble_anyres_max_equal_jax(size, max_n, shrinks):
    """anyres_max_N (JAX's test_assemble_anyres_max, 336-pixel patches of
    4x4 features): the unpadded map downscaled with JAX's antialiased
    linear resize when it exceeds N patch areas by more than 1.1^2, else
    kept as it is; the base tokens untouched.
    Tolerance 1e-6 absolute (fp32 filter weights summed in another
    order)."""
    side, c = 4, 8
    rng = np.random.default_rng(1)
    npw, nph = anyres.get_anyres_image_grid_shape(
        size, anyres.DEFAULT_GRID_PINPOINTS, 336)
    feats = rng.normal(size=(1 + npw * nph, side * side, c)).astype(np.float32)
    newline = rng.normal(size=(c,)).astype(np.float32)
    full = anyres.assemble_spatial_unpad(feats, size, newline, patch_size=336)
    got = anyres.assemble_spatial_unpad(feats, size, newline, patch_size=336,
                                        max_num_patches=max_n)
    want = janyres.assemble_spatial_unpad(feats, size, newline, patch_size=336,
                                          max_num_patches=max_n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:side * side], feats[0])
    assert (got.shape[0] < full.shape[0]) == shrinks


def test_conversation_templates_equal_jax():
    """All six templates of the port's registry render JAX's prompts, with
    JAX's stop tokens and system messages; llava_llama_3 is the caption
    stage's prompt."""
    from rsvldm_tpu.models.vlm.conversation import conv_templates as jconv
    from rsvldm_tpu_torch.models.vlm.conversation import conv_templates
    assert sorted(conv_templates) == sorted(jconv) and len(jconv) == 6
    for name, conv in conv_templates.items():
        j = jconv[name]
        assert (conv.name, conv.stop_tokens, conv.system) == (
            j.name, j.stop_tokens, j.system)
        for msg in ("describe <image>", "hi"):
            assert conv.prompt(msg) == j.prompt(msg)
            assert conv.render("sys", msg) == j.render("sys", msg)
    assert conv_templates["llava_llama_3"].prompt("x") == tgen.llama3_chat_prompt("x")


# ------------------------------------------------------------------ llama
@pytest.fixture(scope="module")
def llama_tree():
    jm = JLlama(JL)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(JL, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    return to_np(randomize(shapes, 23))


def _models(tree, mode):
    """(JAX module, JAX params, port module) for mode None / int8 / int4."""
    port = _load(LlamaModel(TL), params_from_jax("llama", tree, TL))
    if mode is None:
        return JLlama(JL), tree, port
    qtree = {"params": quantize_llama_params(tree["params"], embed_dtype=jnp.bfloat16,
                                             mode=mode)}
    return JLlama(dataclasses.replace(JL, quant=mode)), qtree, quantize_llama_(port, mode)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_llama_prefill_and_decode(llama_tree, mode):
    """Prefill from position 0, then 4 decode steps fed their own greedy
    tokens: logits within 1e-4 (scaled by max(1, |logits|)) at every step,
    and equal caches."""
    jm, jp, tm = _models(llama_tree, mode)
    # a Python-int 0 keeps JAX on its prefill branch; decode positions trace
    prefill = jax.jit(lambda p, t, c: jm.apply(p, t, c, 0, method=jm.from_tokens))
    decode = jax.jit(lambda p, t, c, pos: jm.apply(p, t, c, pos,
                                                   method=jm.from_tokens))
    toks = RNG.integers(0, 256, (1, 5)).astype(np.int32)
    jc, tc = JKVCache.init(JL, 1, 16), KVCache.init(TL, 1, 16)
    jl, jc = prefill(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        tl, tc = tm(tm.embed(torch.from_numpy(toks).long()), tc, 0)
        assert_close(tl.numpy(), jl)
        pos = toks.shape[1]
        for _ in range(4):
            tok = np.asarray(jnp.argmax(jl[0, -1])).astype(np.int32).reshape(1, 1)
            jl, jc = decode(jp, jnp.asarray(tok), jc, pos)
            tl, tc = tm(tm.embed(torch.from_numpy(tok).long()), tc, pos)
            assert_close(tl.numpy(), jl)
            pos += 1
    assert_close(tc.k.numpy(), jc.k)
    assert_close(tc.v.numpy(), jc.v)


def test_quantized_llama_layout(llama_tree):
    _, jp, tm = _models(llama_tree, "int4")
    sd = tm.state_dict()
    jq = jp["params"]["layer_1"]["down_proj"]
    np.testing.assert_array_equal(sd["model.layers.1.mlp.down_proj.kernel_q4"].numpy(),
                                  np.asarray(jq["kernel_q4"]))
    np.testing.assert_array_equal(sd["model.layers.1.mlp.down_proj.scale"].numpy(),
                                  np.asarray(jq["scale"]))
    assert sd["model.embed_tokens.weight"].dtype == torch.bfloat16
    assert sd["lm_head.scale"].dtype == torch.float32


@pytest.mark.parametrize("mode", [None, "int4"])
def test_greedy_generate_ids_equal(llama_tree, mode):
    jm, jp, tm = _models(llama_tree, mode)
    embeds = (RNG.standard_normal((7, 32)) * 0.5).astype(np.float32)
    cfg = jgen.GenerateConfig(max_new_tokens=6, do_sample=False, pad_to=8)
    want = jgen.generate(jm, jp, jnp.asarray(embeds), cfg, jax.random.PRNGKey(0))
    stats = {}
    got = tgen.generate(tm, torch.from_numpy(embeds),
                        tgen.GenerateConfig(max_new_tokens=6, do_sample=False,
                                            pad_to=8), stats=stats)
    np.testing.assert_array_equal(got, want)
    assert stats["prompt_len"] == 7 and stats["padded_len"] == 8
    assert stats["decode_steps"] == len(got) - 1


def _jax_gumbel(rng, vocab):
    """JAX's draw for token i: `rng` for the first, fold_in(rng, i) after."""
    def draw(i):
        key = rng if i == 0 else jax.random.fold_in(rng, i)
        return torch.tensor(np.asarray(
            jax.random.gumbel(key, (vocab,), jnp.float32)))
    return draw


@pytest.mark.parametrize("mode", [None, "int4"])
def test_sampled_generate_replays_jax_noise(llama_tree, mode):
    """do_sample at T = 0.2 (the config's default): fed JAX's Gumbel stream,
    the port draws JAX's ids, which are not the greedy ones."""
    jm, jp, tm = _models(llama_tree, mode)
    embeds = (RNG.standard_normal((7, 32)) * 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    kw = dict(max_new_tokens=12, temperature=0.2, do_sample=True, pad_to=8)
    want = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(**kw),
                         rng)
    got = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(**kw),
                        noise=_jax_gumbel(rng, TL.vocab_size))
    np.testing.assert_array_equal(got, want)
    greedy = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(
        **dict(kw, do_sample=False)))
    assert len(got) == 12 and not np.array_equal(got, greedy)


def test_sampled_generate_default_noise_is_seeded(llama_tree):
    """Without a noise stream the draws come from a torch.Generator: the
    same seed gives the same ids."""
    _, _, tm = _models(llama_tree, None)
    embeds = torch.from_numpy((RNG.standard_normal((5, 32)) * 0.5).astype(np.float32))
    cfg = tgen.GenerateConfig(max_new_tokens=6, pad_to=8)
    runs = [tgen.generate(tm, embeds, cfg, torch.Generator().manual_seed(9))
            for _ in range(2)]
    np.testing.assert_array_equal(*runs)
    np.testing.assert_array_equal(tgen.generate(tm, embeds, cfg),
                                  tgen.generate(tm, embeds, cfg))


def test_generate_stops_at_eot(llama_tree):
    """The first greedy token made the only eot id: nothing is returned and
    no decode step runs, as JAX trims at the first eot."""
    jm, jp, tm = _models(llama_tree, None)
    embeds = (RNG.standard_normal((3, 32)) * 0.5).astype(np.float32)
    first = int(tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(
        max_new_tokens=1, do_sample=False, pad_to=4))[0])
    want = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(
        max_new_tokens=5, do_sample=False, pad_to=4, eot_ids=(first,)),
        jax.random.PRNGKey(0))
    stats = {}
    got = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(
        max_new_tokens=5, do_sample=False, pad_to=4, eot_ids=(first,)),
        stats=stats)
    assert got.size == want.size == 0 and stats["decode_steps"] == 0


@pytest.mark.parametrize("mode", [None, "int4"])
@pytest.mark.parametrize("sampled", [False, True])
def test_windowed_generate_ids_equal_jax(llama_tree, mode, sampled):
    """40 new tokens, more than two windows of the done-flag read: greedy,
    and at T = 0.2 with JAX's noise, dense and int4, JAX's ids; every step
    the loop allows runs."""
    jm, jp, tm = _models(llama_tree, mode)
    embeds = (RNG.standard_normal((7, 32)) * 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    kw = dict(max_new_tokens=40, temperature=0.2, do_sample=sampled, pad_to=8)
    want = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(**kw),
                         rng)
    stats = {}
    got = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(**kw),
                        noise=_jax_gumbel(rng, TL.vocab_size), stats=stats)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 40 and stats["decode_steps"] == 39
    assert tgen.DONE_EVERY < 39


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_eot_inside_a_window(llama_tree, sampled):
    """The eot id made a token JAX draws at position j (5 where that id
    does not occur before it): both trim there, and the port stops at the
    end of the first window of DONE_EVERY steps, not at max_new_tokens."""
    jm, jp, tm = _models(llama_tree, None)
    embeds = (RNG.standard_normal((6, 32)) * 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    kw = dict(max_new_tokens=40, temperature=0.2, do_sample=sampled, pad_to=8)
    ids = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(**kw),
                        rng)
    j = next(j for j in range(5, 14) if ids[j] not in ids[:j])
    kw["eot_ids"] = (int(ids[j]),)
    want = jgen.generate(jm, jp, jnp.asarray(embeds), jgen.GenerateConfig(**kw),
                         rng)
    stats = {}
    got = tgen.generate(tm, torch.from_numpy(embeds), tgen.GenerateConfig(**kw),
                        noise=_jax_gumbel(rng, TL.vocab_size), stats=stats)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ids[:j])
    assert stats["decode_steps"] == tgen.DONE_EVERY


def test_generate_reuses_its_bucket(llama_tree):
    """A graph cache keeps one loop state per bucket: a second prompt of
    another length in the same bucket reuses it (over the first prompt's
    cache contents) and gets the ids of a fresh call; another bucket gets
    its own."""
    _, _, tm = _models(llama_tree, "int4")
    cfg = tgen.GenerateConfig(max_new_tokens=20, do_sample=False, pad_to=8)
    prompts = [torch.from_numpy((RNG.standard_normal((s, 32)) * 0.5)
                                .astype(np.float32)) for s in (7, 5, 11)]
    cache: dict = {}
    got = [tgen.generate(tm, p, cfg, graph_cache=cache) for p in prompts]
    fresh = [tgen.generate(tm, p, cfg) for p in prompts]
    for a, b in zip(got, fresh):
        np.testing.assert_array_equal(a, b)
    assert sorted(k[0] for k in cache) == [8, 16]


# -------------------------------------------------------------- captioner
def _tiny_llava_state_dict():
    import sys
    sys.path.insert(0, "tests")
    import test_captioner
    return test_captioner._tiny_llava_state_dict()


def test_caption_string_equal(tmp_path):
    """One HF-named LLaVA state dict (tests/test_captioner.py's) read by
    the JAX loader from safetensors and by from_state_dict, int8 decoder
    (the default; the int4 one runs in tests/test_torch_pipeline.py): the
    same greedy caption."""
    quant = "int8"
    from safetensors.torch import save_file
    sd = _tiny_llava_state_dict()
    (tmp_path / "llava").mkdir()
    save_file(sd, str(tmp_path / "llava" / "model.safetensors"))
    jcap = JCaptioner.load(tmp_path, llama_cfg=JL, vision_cfg=JV,
                           tokenizer=FakeTokenizer(), quant=quant)
    tcap = LlavaCaptioner.from_state_dict(sd, TL, TV, FakeTokenizer(), quant=quant)
    img = Image.fromarray(RNG.integers(0, 255, (50, 70, 3), dtype=np.uint8))
    lcfg = LlavaConfig(max_new_tokens=8, temperature=0.0, do_sample=False)
    want = jcap.caption(img, lcfg)
    got = tcap.caption(img, lcfg)
    assert got == want
    assert tcap.last_stats["decode_steps"] >= 0


def test_splice_image_embeds_equal():
    ids = np.asarray([5, 9, jgen.IMAGE_TOKEN_INDEX, 7], np.int32)
    text = RNG.standard_normal((4, 6)).astype(np.float32)
    image = RNG.standard_normal((3, 6)).astype(np.float32)
    want = jgen.splice_image_embeds(ids, jnp.asarray(text), jnp.asarray(image))
    got = tgen.splice_image_embeds(ids, torch.from_numpy(text), torch.from_numpy(image))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgen.tokenize_with_image("a<image>b", lambda t: [ord(c) for c in t]).tolist() \
        == jgen.tokenize_with_image("a<image>b", lambda t: [ord(c) for c in t]).tolist()


def test_captioner_load_without_assets(tmp_path, llava_dir):
    """No llava/ or no weights in it: None, as JAX. Weights without
    tokenizer.json: a clear error. With it: the real load."""
    assert LlavaCaptioner.load(tmp_path) is None
    (tmp_path / "llava").mkdir()
    assert LlavaCaptioner.load(tmp_path) is None
    for f in (llava_dir / "llava").glob("*.safetensors"):
        (tmp_path / "llava" / f.name).symlink_to(f)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        LlavaCaptioner.load(tmp_path, llama_cfg=TL2, vision_cfg=TV)
    cap = LlavaCaptioner.load(llava_dir, llama_cfg=TL2, vision_cfg=TV)
    assert cap.load_stats["files"][-1].endswith("Llava-next")
    assert cap.load_stats["peft_merged"] == 4
    assert cap.tokenizer.encode("<|eot_id|>") == [509]


# ------------------------------------------- captioner from a checkpoint dir
# the tiny decoder with room for a byte-level vocabulary: 256 bytes, merges
# and fillers below 500, 12 special tokens at 500-511
TL2, JL2 = LlamaConfig(**dict(_L, vocab_size=512)), JLlamaConfig(**dict(_L, vocab_size=512))
LORA_R, LORA_ALPHA = 4, 8


def _lcfg(**kw):
    return LlavaConfig(max_new_tokens=8, temperature=0.0, do_sample=False, **kw)


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
    """<ckpt>/llava as two shards (fp32, fp16) of the tiny LLaVA state dict
    (vocab 512) with a Llama-3-style tokenizer.json, and a Llava-next PEFT
    adapter (r=4, alpha=8 on q_proj and v_proj of both layers)."""
    from safetensors.torch import save_file
    cd = tmp_path_factory.mktemp("llava_ckpt")
    g = torch.Generator().manual_seed(5)
    sd = _tiny_llava_state_dict()
    sd["model.embed_tokens.weight"] = torch.randn(512, 32, generator=g) * 0.05
    sd["lm_head.weight"] = torch.randn(512, 32, generator=g) * 0.05
    keys = sorted(sd)
    (cd / "llava").mkdir()
    save_file({k: sd[k].contiguous() for k in keys[:len(keys) // 2]},
              str(cd / "llava" / "model-00001-of-00002.safetensors"))
    save_file({k: sd[k].half().contiguous() for k in keys[len(keys) // 2:]},
              str(cd / "llava" / "model-00002-of-00002.safetensors"))
    prompt = tgen.llama3_chat_prompt(LlavaConfig().img_prompt.format(
        DEFAULT_IMAGE_TOKEN="<image>"))
    chip_smoke.Llama3Assets([prompt], n_merges=200, special_start=500,
                            n_special=12).write(cd / "llava")
    (cd / "Llava-next").mkdir()
    adapter = {}
    for i in range(2):
        for proj, out in (("q_proj", 32), ("v_proj", 16)):
            k = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            adapter[f"{k}.lora_A.weight"] = torch.randn(LORA_R, 32, generator=g) * 0.3
            adapter[f"{k}.lora_B.weight"] = torch.randn(out, LORA_R, generator=g) * 0.3
    save_file(adapter, str(cd / "Llava-next" / "adapter_model.safetensors"))
    (cd / "Llava-next" / "adapter_config.json").write_text(
        json.dumps({"r": LORA_R, "lora_alpha": LORA_ALPHA}))
    return cd


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """A LoRA archive and a projector archive written by the JAX package."""
    from rsvldm_tpu.training.vlm_trainer import (LoraConfig as JLoraConfig,
                                                 save_lora_npz, save_projector_npz)
    d = tmp_path_factory.mktemp("archives")
    rng = np.random.default_rng(11)
    lora = {f"layer_{i}": {p: {"a": rng.standard_normal((din, 4), np.float32) * 0.3,
                               "b": rng.standard_normal((4, dout), np.float32) * 0.3}
                           for p, din, dout in (("q_proj", 32, 32), ("o_proj", 32, 32),
                                                ("gate_proj", 32, 64),
                                                ("down_proj", 64, 32))}
            for i in range(2)}
    save_lora_npz(lora, JLoraConfig(r=4, alpha=8), d / "lora.npz")
    proj = {"params": {"fc0": {"kernel": rng.standard_normal((24, 32), np.float32) * 0.2,
                               "bias": rng.standard_normal(32, np.float32) * 0.1},
                       "fc1": {"kernel": rng.standard_normal((32, 32), np.float32) * 0.2,
                               "bias": rng.standard_normal(32, np.float32) * 0.1}}}
    save_projector_npz(proj, d / "projector.npz")
    return d


@pytest.mark.parametrize("quant", [None, "int4"])
def test_load_from_dir_equal_jax(llava_dir, quant):
    """Shards + PEFT adapter + tokenizer.json: the merged (and quantized)
    decoder equals JAX's tree, the tower, projector and newline too, and the
    greedy caption is JAX's."""
    jcap = JCaptioner.load(llava_dir, llama_cfg=JL2, vision_cfg=JV, quant=quant)
    tcap = LlavaCaptioner.load(llava_dir, llama_cfg=TL2, vision_cfg=TV, quant=quant)
    got = tcap.llama.state_dict()
    jp = jcap.llama_params["params"]
    if quant is None:
        want = params_from_jax("llama", jcap.llama_params, TL2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    else:
        for i in range(2):
            for sub, proj in (("self_attn", "q_proj"), ("mlp", "down_proj")):
                pre = f"model.layers.{i}.{sub}.{proj}"
                np.testing.assert_array_equal(got[f"{pre}.kernel_q4"].numpy(),
                                              np.asarray(jp[f"layer_{i}"][proj]["kernel_q4"]))
                np.testing.assert_array_equal(got[f"{pre}.scale"].numpy(),
                                              np.asarray(jp[f"layer_{i}"][proj]["scale"]))
    vis = params_from_jax("clip_vision", jcap.vision_params, TV)
    for k, v in tcap.vision.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), vis[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(tcap.image_newline.numpy(), np.asarray(jcap.image_newline))
    img = Image.fromarray(RNG.integers(0, 255, (50, 70, 3), dtype=np.uint8))
    assert tcap.caption(img, _lcfg()) == jcap.caption(img, _lcfg())
    assert tcap.load_stats["peft_merged"] == 4


def test_peft_merge_is_the_fp32_sum(llava_dir):
    """q_proj of layer 1 (in the fp16 shard or the fp32 one): W + (8/4) B A
    in fp32, before any cast."""
    from rsvldm_tpu_torch.models.vlm.captioner import load_sharded, merge_peft
    sd, _ = load_sharded(llava_dir / "llava")
    merged, n = merge_peft(sd, llava_dir / "Llava-next")
    asd, _ = load_sharded(llava_dir / "Llava-next")
    k = "model.layers.1.self_attn.q_proj"
    a = asd[f"base_model.model.{k}.lora_A.weight"].numpy()
    b = asd[f"base_model.model.{k}.lora_B.weight"].numpy()
    want = sd[f"{k}.weight"].float().numpy() + 2.0 * (b @ a)
    assert n == 4 and merged[f"{k}.weight"].dtype == torch.float32
    np.testing.assert_array_equal(merged[f"{k}.weight"].numpy(), want)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_lora_archive_caption_equal_jax(llava_dir, archives, quant):
    """A JAX-written LoRA archive: folded into the dense decoder, the runtime
    branch of the int4 one; JAX's greedy caption either way, and not the
    caption without it."""
    npz = archives / "lora.npz"
    jcap = JCaptioner.load(llava_dir, llama_cfg=JL2, vision_cfg=JV, quant=quant,
                           lora_npz=npz)
    tcap = LlavaCaptioner.load(llava_dir, llama_cfg=TL2, vision_cfg=TV, quant=quant,
                               lora_npz=npz)
    assert (tcap.lora is not None) == (quant is not None)
    img = Image.fromarray(RNG.integers(0, 255, (50, 70, 3), dtype=np.uint8))
    got = tcap.caption(img, _lcfg())
    assert got == jcap.caption(img, _lcfg())
    plain = LlavaCaptioner.load(llava_dir, llama_cfg=TL2, vision_cfg=TV, quant=quant)
    assert plain.caption(img, _lcfg()) != got


def test_projector_archive_caption_equal_jax(llava_dir, archives):
    """A JAX-written projector archive replaces the checkpoint's projector:
    its weights, and JAX's greedy caption (int8 decoder)."""
    npz = archives / "projector.npz"
    jcap = JCaptioner.load(llava_dir, llama_cfg=JL2, vision_cfg=JV, quant="int8",
                           projector_npz=npz)
    tcap = LlavaCaptioner.load(llava_dir, llama_cfg=TL2, vision_cfg=TV, quant="int8",
                               projector_npz=npz)
    want = params_from_jax("projector", jcap.projector_params, None)
    for k, v in tcap.projector.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    img = Image.fromarray(RNG.integers(0, 255, (50, 70, 3), dtype=np.uint8))
    assert tcap.caption(img, _lcfg()) == jcap.caption(img, _lcfg())


# ------------------------------------------------------------ round trips
def _assert_trees_equal(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(p))


def test_round_trip_llama(llama_tree):
    sd = params_from_jax("llama", llama_tree, TL)
    _assert_trees_equal(convert_hf.convert_llama(sd, JL), llama_tree)


def test_round_trip_clip_vision(vision):
    _, tree, _ = vision
    sd = params_from_jax("clip_vision", tree, TV)
    _assert_trees_equal(convert_hf.convert_hf_clip_vision(sd, JV), tree)


def test_round_trip_llava_state_dict(llama_tree, vision):
    """llava_from_jax gives the reference checkpoint's names: the JAX
    converters read every part back bit-exact."""
    _, vtree, _ = vision
    ptree = {"params": {"fc0": {"kernel": RNG.standard_normal((24, 32), np.float32),
                                "bias": RNG.standard_normal(32, np.float32)},
                        "fc1": {"kernel": RNG.standard_normal((32, 32), np.float32),
                                "bias": RNG.standard_normal(32, np.float32)}}}
    newline = RNG.standard_normal(32, np.float32)
    sd = llava_from_jax(llama_tree, vtree, ptree, newline, TL, TV)
    _assert_trees_equal(convert_hf.convert_mm_projector(sd), ptree)
    vsd = {k[len("model.vision_tower.vision_tower."):]: v for k, v in sd.items()
           if k.startswith("model.vision_tower.vision_tower.")}
    _assert_trees_equal(convert_hf.convert_hf_clip_vision(vsd, JV), vtree)
    _assert_trees_equal(convert_hf.convert_llama(sd, JL), llama_tree)
    np.testing.assert_array_equal(sd["model.image_newline"].numpy(), newline)
    cap = LlavaCaptioner.from_state_dict(sd, TL, TV, FakeTokenizer())
    np.testing.assert_array_equal(cap.image_newline.numpy(), newline)


def test_quantize_llama_frees_each_dense_weight(llama_tree):
    """Module by module: no dense projection weight outlives the call."""
    import gc
    import weakref
    tm = _load(LlamaModel(TL), params_from_jax("llama", llama_tree, TL))
    refs = [weakref.ref(m.weight) for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)]
    quantize_llama_(tm, "int4")
    gc.collect()
    assert len(refs) == 15 and all(r() is None for r in refs)
