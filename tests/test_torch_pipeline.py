"""The whole slice: the JAX SuperResolutionPipeline.process() and the port's,
tiny geometry, fp32 on the CPU, the same (randomized) weights, and the port
fed the noise the JAX pipeline draws, rebuilt from its key chain. Without the
caption stage (no_llava) and with it (the tiny int4 captioner of
tests/test_captioner.py, greedy, both read from ckpt/llava): both PNGs agree
within 1 uint8 level, the first-block cache decisions and the captions are
identical. Then both read every family from the reference checkpoint layout
(written from the same randomized trees, fp16 and fp32, with an SR-v0Q
override and a denoise_encoder) and a tiny clip_vocab: every family's
weights equal JAX's loaded tree exactly, the CLIP tokens (both pads) are
JAX's and the PNGs within 1 uint8 level. And both with Stage 1 as DDIM
(eta 0.5, JAX's key chain replayed): PNGs within 1 uint8 level."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.config import (LlavaConfig as JLlavaConfig,
                               PipelineConfig as JPipelineConfig,
                               RefinementConfig as JRefinementConfig,
                               Stage1Config as JStage1Config)
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                     RefinementConfig, Stage1Config)
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
from rsvldm_tpu_torch.models.sr3.diffusion import ddim_timesteps
from rsvldm_tpu_torch.pipeline import ReplayNoise, SuperResolutionPipeline
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, randomize,
                              sr3_noise_from_key, to_np)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from test_torch_samplers import ddim_noise_from_key  # noqa: E402

torch.set_num_threads(1)
SEED, STEPS1, EDM_STEPS = 7, 8, 2


def _cfg(mod, ckpt, out, llava=None, stage1=None):
    kw = dict(no_llava=True) if llava is None else dict(llava=llava)
    return mod[0](ckpt_dir=str(ckpt), output_dir=str(out), upscale=8,
                  seed=SEED, params_dtype="fp32",
                  stage1=mod[1](steps=STEPS1, **(stage1 or {})),
                  refine=mod[2](min_size=64, edm_steps=EDM_STEPS, size_bucket=0),
                  **kw)


def _jax_noise(seed, stage1_shape, latent_shape, edm_steps, ddim_steps=None):
    """The draws of JAX process(): run_stage1 splits the pipeline key once
    (pipeline.py:335) for sr3_sample (sr3/diffusion.py:74-89), or with
    ddim_steps for sr3_sample_ddim (:101-156); _refine_core
    splits it into k_enc / k_noise / k_loop (pipeline.py:456) for the VAE
    posterior sample (vae/model.py:173-174), the initial EDM noise and the
    per-step churn noise (samplers.py:158)."""
    rng, sub = jax.random.split(jax.random.PRNGKey(seed))
    if ddim_steps is None:
        stage1 = sr3_noise_from_key(sub, STEPS1, stage1_shape)
    else:
        stage1 = ddim_noise_from_key(sub, ddim_timesteps(STEPS1, ddim_steps),
                                     stage1_shape)
    _, k_enc, k_noise, k_loop = jax.random.split(rng, 4)
    normal = lambda k: np.asarray(jax.random.normal(k, latent_shape, jnp.float32))
    churn = np.stack([normal(jax.random.fold_in(k_loop, i)) for i in range(edm_steps)])
    return {"stage1": [stage1], "vae_sample": [normal(k_enc)],
            "edm_init": [normal(k_noise)], "churn": [churn]}


def _record_captions(pipe, captions: list):
    run = pipe.run_caption
    pipe.run_caption = lambda img: captions.append(run(img)) or captions[-1]


FAMILIES = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
TORCH_CFGS = {"sr3": TORCH_TINY["sr3"], "unet": TORCH_TINY["sdxl"],
              "control": TORCH_TINY["sdxl"], "vae": TORCH_TINY["vae"],
              "clip_l": TORCH_TINY["clip_l"], "big_g": TORCH_TINY["big_g"]}


def _record_tokens(pipe, method, out: list):
    fn = getattr(pipe, method)

    def wrapped(texts):
        res = fn(texts)
        out.append([np.asarray(r).astype(np.int64) for r in res])
        return res
    setattr(pipe, method, wrapped)


def _run_both(work, ckpt, jax_kw=None, llava_kw=None, port_kw=None,
              from_files=False, stage1=None):
    """process() of both pipelines on work/in.png -> (jax pipe, port pipe),
    outputs in work/jax and work/torch. The port gets JAX's loaded trees as
    state dicts, or with from_files reads ckpt itself."""
    Image.fromarray((np.random.default_rng(3).random((2, 2, 3)) * 255)
                    .astype("uint8")).save(work / "in.png")
    families = FAMILIES
    mp = pytest.MonkeyPatch()
    # missing checkpoints: random weights of the real tree's shapes instead
    # of the Flax init (which zeroes the control convs and is slow eagerly)
    mp.setattr(JPipeline, "_init_params", lambda self, what, init_fn: randomize(
        jax.eval_shape(init_fn, jax.random.PRNGKey(0)), 100 + families.index(what)))
    jllava = None if llava_kw is None else JLlavaConfig(**llava_kw)
    tllava = None if llava_kw is None else LlavaConfig(**llava_kw)
    try:
        jp = JPipeline(_cfg((JPipelineConfig, JStage1Config, JRefinementConfig),
                            ckpt, work / "jax", jllava, stage1),
                       model_cfgs=JAX_TINY,
                       **(jax_kw or {}))
        jp._ensure_stage2()
        jp.trees = {fam: to_np(getattr(jp, f"{fam}_params")) for fam in families}
        jp.captions, jp.tokens = [], []
        _record_captions(jp, jp.captions)
        _record_tokens(jp, "_tokenize", jp.tokens)
        jp.process(str(work / "in.png"))
    finally:
        mp.undo()
    sds = None if from_files else {
        fam: params_from_jax(fam, tree, TORCH_CFGS[fam])
        for fam, tree in jp.trees.items()}
    noise = _jax_noise(SEED, (1, 16, 16, 3), (1, 32, 32, 4), EDM_STEPS,
                       (stage1 or {}).get("ddim_steps"))
    tp = SuperResolutionPipeline(
        _cfg((PipelineConfig, Stage1Config, RefinementConfig), ckpt,
             work / "torch", tllava, stage1), device="cpu",
        model_cfgs=TORCH_TINY,
        state_dicts=sds, noise=ReplayNoise(noise), **(port_kw or {}))
    tp.captions, tp.tokens = [], []
    _record_captions(tp, tp.captions)
    _record_tokens(tp, "_tokens", tp.tokens)
    tp.process(str(work / "in.png"))
    return jp, tp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_slice")
    jp, tp = _run_both(work, work / "no_ckpt")
    return work, jp, tp


@pytest.fixture(scope="module")
def caption_runs(tmp_path_factory):
    """Both pipelines with the caption stage, both reading the tiny LLaVA
    state dict from ckpt/llava (tiny geometry and tokenizer through
    llava_load_kw); int4 decoder, greedy, 4 new tokens."""
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
    port_kw = dict(llava_load_kw=dict(llama_cfg=LlamaConfig(**lcfg),
                                      vision_cfg=CLIPVisionConfig(**vcfg),
                                      tokenizer=tc.FakeTokenizer()))
    jp, tp = _run_both(work, work / "ckpt", jax_kw,
                       dict(quant="int4", max_new_tokens=4, temperature=0.0,
                            do_sample=False), port_kw)
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


@pytest.fixture(scope="module")
def ddim_runs(tmp_path_factory):
    """Both pipelines with Stage 1 as DDIM: 5 steps at eta 0.5 on the
    8-step schedule, JAX's key chain replayed."""
    work = tmp_path_factory.mktemp("torch_slice_ddim")
    jp, tp = _run_both(work, work / "no_ckpt", stage1=dict(
        sampler="ddim", ddim_steps=5, ddim_eta=0.5))
    return work, jp, tp


@pytest.mark.parametrize("name", ["sr3_in.png", "in_final_0.png"])
def test_ddim_pngs_within_one_level(ddim_runs, name):
    work, _, tp = ddim_runs
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    # the replayed draws have the shapes the DDIM loop asked for, all used
    assert tp.cfg.stage1.sampler == "ddim"
    assert all(not v for v in tp.noise.draws.values())


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
    assert tp.weight_sources["llava"][0].endswith("model.safetensors")
    assert len(tp.captions) == len(jp.captions) == 1
    assert tp.captions == jp.captions and tp.captions[0]
    assert tp.caption_stats["decode_steps"] == 3  # max_new_tokens - 1, no eot
    assert "caption" in tp.timings
    np.testing.assert_array_equal(tp.last_dfb["trace"], np.asarray(jp.last_dfb["trace"]))



# ------------------------------------------------- from the checkpoint files
OVERRIDE = ("conditioner.embedders.0.transformer."
            "text_model.embeddings.token_embedding.weight")


def write_reference_layout(cd: Path, trees: dict, denoise: bool = True):
    """The reference checkpoint directory (tests/test_e2e_ckpt_roundtrip.py
    :182-217) from JAX trees: SR3 as an fp32 .pth; the juggernaut
    safetensors in fp16 (UNet, VAE without its twin encoder, both text
    towers); SR-v0Q.ckpt in fp32 (GLVControl, the VAE's denoise_encoder
    when `denoise`, and a value that overrides a juggernaut one); a tiny
    clip_vocab with SOT / EOT at 998 / 999."""
    from safetensors.torch import save_file
    sd = {fam: params_from_jax(fam, trees[fam], TORCH_CFGS[fam]) for fam in FAMILIES}
    cd.mkdir(parents=True, exist_ok=True)
    torch.save(sd["sr3"], cd / "I1000000_E800_gen.pth")
    jug = {}
    for fam, prefix in (("unet", "model.diffusion_model"), ("vae", "first_stage_model"),
                        ("clip_l", "conditioner.embedders.0.transformer"),
                        ("big_g", "conditioner.embedders.1.model")):
        jug.update({f"{prefix}.{k}": v.half().contiguous() for k, v in sd[fam].items()
                    if not k.startswith("denoise_encoder.")})
    save_file(jug, str(cd / "juggernautXL_v8Rundiffusion.safetensors"))
    srq = {f"model.control_model.{k}": v for k, v in sd["control"].items()}
    if denoise:
        srq.update({f"first_stage_model.{k}": v for k, v in sd["vae"].items()
                    if k.startswith("denoise_encoder.")})
    srq[OVERRIDE] = torch.full_like(sd["clip_l"][OVERRIDE.split("transformer.")[1]], 0.125)
    torch.save({"state_dict": srq}, cd / "SR-v0Q.ckpt")
    r = RefinementConfig()
    chip_smoke.ClipAssets([r.a_prompt, r.n_prompt], sot=998).write(cd / "clip_vocab")


@pytest.fixture(scope="module")
def file_runs(runs, tmp_path_factory):
    """Both pipelines from the reference layout alone (no family seeded)."""
    _, jp0, _ = runs
    work = tmp_path_factory.mktemp("torch_slice_files")
    write_reference_layout(work / "ckpt", jp0.trees)
    jp, tp = _run_both(work, work / "ckpt", from_files=True)
    return work, jp, tp


def _port_tree(tp, fam):
    return {k: v.numpy() for k, v in getattr(tp, fam).state_dict().items()}


@pytest.mark.parametrize("fam", FAMILIES)
def test_files_weights_equal_jax_load(file_runs, fam):
    """The port's loaded family equals params_from_jax of the tree JAX's
    load_or_convert gave, exactly; the override of SR-v0Q won."""
    work, jp, tp = file_runs
    assert tp.weight_sources[fam] and tp.weight_sources[fam] not in ("seeded", "state_dict")
    assert (work / "ckpt" / "jax" / fam).exists()  # JAX converted the files too
    want = params_from_jax(fam, jp.trees[fam], TORCH_CFGS[fam])
    got = _port_tree(tp, fam)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    if fam == "clip_l":
        assert (got["text_model.embeddings.token_embedding.weight"] == 0.125).all()
    if fam == "vae":  # the twin encoder came from SR-v0Q, not the encoder
        assert not np.array_equal(got["denoise_encoder.conv_in.weight"],
                                  got["encoder.conv_in.weight"])


def test_files_clip_tokens_equal_jax(file_runs):
    """Cond and uncond tokens: CLIP-L padded with EOT, bigG with 0, JAX's."""
    _, jp, tp = file_runs
    assert tp.tokenizer is not None and len(tp.tokens) == len(jp.tokens) == 2
    for (gl, gg), (wl, wg) in zip(tp.tokens, jp.tokens):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gg, wg)
    # a short text shows the two pads
    (gl, gg), (wl, wg) = tp._tokens(["ok"]), jp._tokenize(["ok"])
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    assert (gl[:, -1] == 999).all() and (gg[:, -1] == 0).all()


@pytest.mark.parametrize("name", ["sr3_in.png", "in_final_0.png"])
def test_files_pngs_within_one_level(file_runs, name):
    work, _, _ = file_runs
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    assert a.shape == b.shape == (16, 16, 3) and a.std() > 0
    assert np.abs(a - b).max() <= 1


def test_files_without_denoise_encoder(runs, tmp_path):
    """No denoise_encoder in the files: the twin encoder is the encoder, as
    JAX's converter gives it; the stage-2 families come from the files."""
    _, jp0, _ = runs
    write_reference_layout(tmp_path, jp0.trees, denoise=False)
    tp = SuperResolutionPipeline(
        _cfg((PipelineConfig, Stage1Config, RefinementConfig), tmp_path,
             tmp_path / "out"), device="cpu", model_cfgs=TORCH_TINY)
    tp.ensure_stage2()
    sd = _port_tree(tp, "vae")
    for k in (k for k in sd if k.startswith("encoder.")):
        np.testing.assert_array_equal(sd["denoise_" + k], sd[k])
    want = params_from_jax("vae", jp0.trees["vae"], TORCH_TINY["vae"])
    np.testing.assert_array_equal(sd["encoder.conv_in.weight"],
                                  want["encoder.conv_in.weight"].half().float().numpy())
    assert tp.weight_sources["vae"] == [str(tmp_path / n) for n in (
        "juggernautXL_v8Rundiffusion.safetensors", "SR-v0Q.ckpt")]


def test_state_dicts_before_files_before_seeded(runs, tmp_path):
    """A family's state dict wins over the files; a family with neither is
    seeded with the warning."""
    _, jp0, _ = runs
    write_reference_layout(tmp_path, jp0.trees)
    (tmp_path / "I1000000_E800_gen.pth").unlink()
    sd = params_from_jax("unet", jp0.trees["unet"], TORCH_TINY["sdxl"])
    tp = SuperResolutionPipeline(
        _cfg((PipelineConfig, Stage1Config, RefinementConfig), tmp_path,
             tmp_path / "out"), device="cpu", model_cfgs=TORCH_TINY,
        state_dicts={"unet": sd})
    tp.ensure_stage2()
    assert tp.weight_sources["sr3"] == "seeded"
    assert tp.weight_sources["unet"] == "state_dict"
    assert isinstance(tp.weight_sources["control"], list)
    got = tp.unet.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
