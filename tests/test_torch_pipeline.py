"""The whole slice: the JAX SuperResolutionPipeline.process() and the port's,
tiny geometry, fp32 on the CPU, the same (randomized) weights, and the port
fed the noise the JAX pipeline draws, rebuilt from its key chain. Without the
caption stage (no_llava) and with it (the tiny int4 captioner of
tests/test_captioner.py, greedy): both PNGs agree within 1 uint8 level, the
first-block cache decisions and the captions are identical."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.native
from rsvldm_tpu.config import (LlavaConfig as JLlavaConfig,
                               PipelineConfig as JPipelineConfig,
                               RefinementConfig as JRefinementConfig,
                               Stage1Config as JStage1Config)
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                     RefinementConfig, Stage1Config)
from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
from rsvldm_tpu_torch.pipeline import ReplayNoise, SuperResolutionPipeline
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, randomize,
                              sr3_noise_from_key, to_np)

torch.set_num_threads(1)
SEED, STEPS1, EDM_STEPS = 7, 8, 2


def _cfg(mod, ckpt, out, llava=None):
    kw = dict(no_llava=True) if llava is None else dict(llava=llava)
    return mod[0](ckpt_dir=str(ckpt), output_dir=str(out), upscale=8,
                  seed=SEED, params_dtype="fp32",
                  stage1=mod[1](steps=STEPS1),
                  refine=mod[2](min_size=64, edm_steps=EDM_STEPS, size_bucket=0),
                  **kw)


def _jax_noise(seed, stage1_shape, latent_shape, edm_steps):
    """The draws of JAX process(): run_stage1 splits the pipeline key once
    (pipeline.py:335) for sr3_sample (sr3/diffusion.py:74-89); _refine_core
    splits it into k_enc / k_noise / k_loop (pipeline.py:456) for the VAE
    posterior sample (vae/model.py:173-174), the initial EDM noise and the
    per-step churn noise (samplers.py:158)."""
    rng, sub = jax.random.split(jax.random.PRNGKey(seed))
    stage1 = sr3_noise_from_key(sub, STEPS1, stage1_shape)
    _, k_enc, k_noise, k_loop = jax.random.split(rng, 4)
    normal = lambda k: np.asarray(jax.random.normal(k, latent_shape, jnp.float32))
    churn = np.stack([normal(jax.random.fold_in(k_loop, i)) for i in range(edm_steps)])
    return {"stage1": [stage1], "vae_sample": [normal(k_enc)],
            "edm_init": [normal(k_noise)], "churn": [churn]}


def _record_captions(pipe, captions: list):
    run = pipe.run_caption
    pipe.run_caption = lambda img: captions.append(run(img)) or captions[-1]


def _run_both(work, ckpt, jax_kw=None, llava_kw=None, captioner=None):
    """process() of both pipelines on work/in.png -> (jax pipe, port pipe),
    outputs in work/jax and work/torch."""
    Image.fromarray((np.random.default_rng(3).random((2, 2, 3)) * 255)
                    .astype("uint8")).save(work / "in.png")
    families = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
    mp = pytest.MonkeyPatch()
    # both sides resize with PIL
    mp.setattr(rsvldm_tpu.native, "available", lambda: False)
    # missing checkpoints: random weights of the real tree's shapes instead
    # of the Flax init (which zeroes the control convs and is slow eagerly)
    mp.setattr(JPipeline, "_init_params", lambda self, what, init_fn: randomize(
        jax.eval_shape(init_fn, jax.random.PRNGKey(0)), 100 + families.index(what)))
    jllava = None if llava_kw is None else JLlavaConfig(**llava_kw)
    tllava = None if llava_kw is None else LlavaConfig(**llava_kw)
    try:
        jp = JPipeline(_cfg((JPipelineConfig, JStage1Config, JRefinementConfig),
                            ckpt, work / "jax", jllava), model_cfgs=JAX_TINY,
                       **(jax_kw or {}))
        jp._ensure_stage2()
        trees = {fam: to_np(getattr(jp, f"{fam}_params")) for fam in families}
        jp.captions = []
        _record_captions(jp, jp.captions)
        jp.process(str(work / "in.png"))
    finally:
        mp.undo()
    cfgs = {"sr3": TORCH_TINY["sr3"], "unet": TORCH_TINY["sdxl"],
            "control": TORCH_TINY["sdxl"], "vae": TORCH_TINY["vae"],
            "clip_l": TORCH_TINY["clip_l"], "big_g": TORCH_TINY["big_g"]}
    sds = {fam: params_from_jax(fam, tree, cfgs[fam]) for fam, tree in trees.items()}
    noise = _jax_noise(SEED, (1, 16, 16, 3), (1, 32, 32, 4), EDM_STEPS)
    tp = SuperResolutionPipeline(
        _cfg((PipelineConfig, Stage1Config, RefinementConfig), ckpt,
             work / "torch", tllava), device="cpu", model_cfgs=TORCH_TINY,
        state_dicts=sds, noise=ReplayNoise(noise), captioner=captioner)
    tp.captions = []
    _record_captions(tp, tp.captions)
    tp.process(str(work / "in.png"))
    return jp, tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_slice")
    jp, tp = _run_both(work, work / "no_ckpt")
    return work, jp, tp


@pytest.fixture(scope="module")
def caption_runs(tmp_path_factory):
    """Both pipelines with the caption stage: the JAX one reads the tiny
    LLaVA state dict from ckpt/llava, the port is handed a captioner built
    from the same state dict; int4 decoder, greedy, 4 new tokens."""
    from safetensors.torch import save_file
    sys.path.insert(0, "tests")
    import test_captioner as tc
    work = tmp_path_factory.mktemp("torch_slice_caption")
    sd = tc._tiny_llava_state_dict()
    (work / "ckpt" / "llava").mkdir(parents=True)
    save_file(sd, str(work / "ckpt" / "llava" / "model.safetensors"))
    lcfg = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
    vcfg = dict(image_size=28, patch_size=14, width=24, layers=2, heads=2,
                select_layer=-2)
    jax_kw = dict(llava_load_kw=dict(llama_cfg=JLlamaConfig(**lcfg),
                                     vision_cfg=JVisionConfig(**vcfg),
                                     tokenizer=tc.FakeTokenizer()))
    captioner = LlavaCaptioner.from_state_dict(
        sd, LlamaConfig(**lcfg), CLIPVisionConfig(**vcfg), tc.FakeTokenizer(),
        quant="int4")
    jp, tp = _run_both(work, work / "ckpt", jax_kw,
                       dict(quant="int4", max_new_tokens=4, temperature=0.0,
                            do_sample=False), captioner)
    return work, jp, tp


@pytest.mark.parametrize("name", ["sr3_in.png", "in_final_0.png"])
def test_pngs_within_one_level(runs, name):
    work, _, _ = runs
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    assert a.shape == b.shape == (16, 16, 3)
    assert a.std() > 0
    assert np.abs(a - b).max() <= 1


def test_first_block_cache_decisions_equal(runs):
    _, jp, tp = runs
    np.testing.assert_array_equal(tp.last_dfb["trace"], np.asarray(jp.last_dfb["trace"]))
    assert tp.last_dfb["hits"] == jp.last_dfb["hits"]
    assert tp.last_dfb["steps"] == jp.last_dfb["steps"] == EDM_STEPS


def test_replayed_noise_fully_used(runs):
    _, _, tp = runs
    assert all(not v for v in tp.noise.draws.values())
    assert all(tp.outputs_finite.values())


@pytest.mark.parametrize("name", ["sr3_in.png", "in_final_0.png"])
def test_caption_slice_pngs_within_one_level(caption_runs, name):
    work, _, _ = caption_runs
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a - b).max() <= 1


def test_caption_slice_captions_equal(caption_runs):
    _, jp, tp = caption_runs
    assert jp.llava is not None and tp.llava is not None
    assert len(tp.captions) == len(jp.captions) == 1
    assert tp.captions == jp.captions and tp.captions[0]
    assert tp.caption_stats["decode_steps"] == 3  # max_new_tokens - 1, no eot
    assert "caption" in tp.timings
    np.testing.assert_array_equal(tp.last_dfb["trace"], np.asarray(jp.last_dfb["trace"]))

