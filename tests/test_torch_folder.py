"""Folder mode: the JAX ImageBatchProcessor and the port's, tiny geometry,
fp32 on the CPU, the same (randomized) weights, the tiny int4 captioner of
tests/test_captioner.py (greedy, read from ckpt/llava), and the port fed
the noise the JAX processor draws, rebuilt from its key chain. Five images
(four 2x2 and one 3x3: Stage-1 groups of 4 and 1), caption batches of 4
and 1, refinement chunks of 2, 2 and 1 (the last through
run_refinement(use_bucket=True)): every PNG of sr3_output/ and output/
within 1 uint8 level, the same captions, statuses and DFB traces per
chunk, no fallback, the replayed noise fully used. Then `bucket_pad` and
`_refine_group_key` against JAX's; the loops kept across calls (a second
Stage 1 or refinement of a kept shape reuses the loop, captures nothing
and gives a fresh pipeline's PNGs); and refinement with a 128-pixel
bucket, batched and alone, padded and cropped back as JAX does."""

import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.pipeline as jpipeline
from rsvldm_tpu.config import (LlavaConfig as JLlavaConfig,
                               PipelineConfig as JPipelineConfig,
                               RefinementConfig as JRefinementConfig,
                               Stage1Config as JStage1Config)
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
from rsvldm_tpu_torch import pipeline as tpipeline
from rsvldm_tpu_torch.config import (LlavaConfig, PipelineConfig,
                                     RefinementConfig, Stage1Config)
from rsvldm_tpu_torch.diffusion import samplers
from rsvldm_tpu_torch.models.sr3 import diffusion as sr3_diffusion
from rsvldm_tpu_torch.models.sr3.diffusion import ddim_timesteps
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
from rsvldm_tpu_torch.pipeline import (ImageBatchProcessor, ReplayNoise,
                                       SuperResolutionPipeline)
from rsvldm_tpu_torch.utils.weights import params_from_jax
from torch_parity_lib import (JAX_TINY, TORCH_TINY, randomize,
                              sr3_noise_from_key, to_np)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_captioner as tc  # noqa: E402
from test_torch_graphs import _StubGraph, _stub_capture  # noqa: E402

torch.set_num_threads(1)
SEED, STEPS1, EDM_STEPS = 5, 6, 2
FAMILIES = ("sr3", "unet", "control", "vae", "clip_l", "big_g")
TORCH_CFGS = {"sr3": TORCH_TINY["sr3"], "unet": TORCH_TINY["sdxl"],
              "control": TORCH_TINY["sdxl"], "vae": TORCH_TINY["vae"],
              "clip_l": TORCH_TINY["clip_l"], "big_g": TORCH_TINY["big_g"]}
SIDES = {"a": 2, "b": 2, "c": 3, "d": 2, "e": 2}
_L = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, ffn_dim=64)
_V = dict(image_size=28, patch_size=14, width=24, layers=2, heads=2,
          select_layer=-2)
LLAVA = dict(quant="int4", max_new_tokens=4, temperature=0.0, do_sample=False)


def _cfg(mod, work, side, llava=True):
    kw = dict(llava=mod[3](**LLAVA)) if llava else dict(no_llava=True)
    return mod[0](image_dir=str(work / "lr"), ckpt_dir=str(work / "ckpt"),
                  output_dir=str(work / side), upscale=8, seed=SEED,
                  params_dtype="fp32", stage1=mod[1](steps=STEPS1),
                  refine=mod[2](min_size=64, edm_steps=EDM_STEPS,
                                size_bucket=0), **kw)


JMOD = (JPipelineConfig, JStage1Config, JRefinementConfig, JLlavaConfig)
TMOD = (PipelineConfig, Stage1Config, RefinementConfig, LlavaConfig)


def _record(obj, method, out: list, pick=lambda res, self: res):
    fn = getattr(obj, method)

    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(pick(res, obj))
        return res
    setattr(obj, method, wrapped)


def _dfb(_, pipe):
    return "".join("H" if h else "." for h in np.asarray(pipe.last_dfb["trace"]))


def _jax_noise(groups, chunks):
    """The draws of JAX's folder run: run_stage1_batch splits the pipeline
    key once a group (pipeline.py:375) for its sr3_sample; every
    _refine_core splits it into k_enc / k_noise / k_loop (:456)."""
    rng = jax.random.PRNGKey(SEED)
    draws = {"stage1": [], "vae_sample": [], "edm_init": [], "churn": []}
    for n, side in groups:
        rng, sub = jax.random.split(rng)
        draws["stage1"].append(sr3_noise_from_key(sub, STEPS1, (n, side, side, 3)))
    for n in chunks:
        rng, k_enc, k_noise, k_loop = jax.random.split(rng, 4)
        shape = (n, 32, 32, 4)
        normal = lambda k: np.asarray(jax.random.normal(k, shape, jnp.float32))
        draws["vae_sample"].append(normal(k_enc))
        draws["edm_init"].append(normal(k_noise))
        draws["churn"].append(np.stack([normal(jax.random.fold_in(k_loop, i))
                                        for i in range(EDM_STEPS)]))
    return draws


@pytest.fixture(scope="module")
def folder_runs(tmp_path_factory):
    from safetensors.torch import save_file
    work = tmp_path_factory.mktemp("torch_folder")
    (work / "lr").mkdir()
    rng = np.random.default_rng(3)
    for name, side in SIDES.items():
        Image.fromarray((rng.random((side, side, 3)) * 255).astype("uint8")).save(
            work / "lr" / f"{name}.png")
    (work / "ckpt" / "llava").mkdir(parents=True)
    save_file(tc._tiny_llava_state_dict(),
              str(work / "ckpt" / "llava" / "model.safetensors"))

    mp = pytest.MonkeyPatch()
    # random weights of the real trees' shapes instead of the Flax init
    mp.setattr(jpipeline.SuperResolutionPipeline, "_init_params",
               lambda self, what, init_fn: randomize(
                   jax.eval_shape(init_fn, jax.random.PRNGKey(0)),
                   200 + FAMILIES.index(what)))
    # the processor builds its pipeline at the tiny geometries
    base = jpipeline.SuperResolutionPipeline
    mp.setattr(jpipeline, "SuperResolutionPipeline",
               lambda cfg, debug_tiny, mesh, llava_load_kw: base(
                   cfg, mesh=mesh, llava_load_kw=llava_load_kw,
                   model_cfgs=JAX_TINY))
    try:
        jproc = jpipeline.ImageBatchProcessor(
            _cfg(JMOD, work, "jax"), caption_batch=4, refine_batch=2,
            llava_load_kw=dict(llama_cfg=JLlamaConfig(**_L),
                               vision_cfg=JVisionConfig(**_V),
                               tokenizer=tc.FakeTokenizer()))
        jp = jproc.pipe
        jp._ensure_stage2()
        trees = {fam: to_np(getattr(jp, f"{fam}_params")) for fam in FAMILIES}
        jp.captions, jp.dfb = [], []
        _record(jp.llava, "caption_batch", jp.captions)
        _record(jp, "run_caption", jp.captions, lambda res, _: [res])
        _record(jp, "_refine_core", jp.dfb, _dfb)
        jres = jproc.run()
    finally:
        mp.undo()

    noise = ReplayNoise(_jax_noise(groups=((4, 16), (1, 24)), chunks=(2, 2, 1)))
    tproc = ImageBatchProcessor(
        _cfg(TMOD, work, "torch"), device="cpu", caption_batch=4,
        refine_batch=2, model_cfgs=TORCH_TINY, noise=noise,
        state_dicts={fam: params_from_jax(fam, tree, TORCH_CFGS[fam])
                     for fam, tree in trees.items()},
        llava_load_kw=dict(llama_cfg=LlamaConfig(**_L),
                           vision_cfg=CLIPVisionConfig(**_V),
                           tokenizer=tc.FakeTokenizer()))
    tp = tproc.pipe
    tp.captions, tp.dfb, tp.single = [], [], []
    _record(tp, "run_caption_batch", tp.captions)
    _record(tp, "_refine_core", tp.dfb, _dfb)
    _record(tp, "run_refinement", tp.single, lambda res, _: True)
    tres = tproc.run()
    return work, jp, jres, tproc, tres


@pytest.mark.parametrize("name", [f"sr3_output/sr3_{n}.png" for n in SIDES]
                         + [f"output/{n}_final_0.png" for n in SIDES])
def test_folder_pngs_within_one_level(folder_runs, name):
    work = folder_runs[0]
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    side = 8 * SIDES[Path(name).stem.split("_")[-1 if "sr3" in name else 0]]
    assert a.shape == b.shape == (side, side, 3) and a.std() > 0
    assert np.abs(a - b).max() <= 1


def test_folder_captions_statuses_and_batches(folder_runs):
    _, jp, jres, tproc, tres = folder_runs
    assert tres == jres == [(f"{n}.png", "ok") for n in SIDES]
    assert tproc.pipe.captions == jp.captions
    assert [len(c) for c in jp.captions] == [4, 1] and all(jp.captions[0])
    assert tproc.fallbacks == []
    assert [g["n"] for g in tproc.pipe.stage1_groups] == [4, 1]
    assert [c["n"] for c in tproc.caption_batches] == [4, 1]
    assert tproc.caption_batches[0]["rows"] == 4
    assert [c["n"] for c in tproc.refine_chunks] == [2, 2, 1]
    # the last chunk of one went image by image, with the bucket
    assert tproc.pipe.single == [True]


def test_folder_dfb_traces_equal(folder_runs):
    _, jp, _, tproc, _ = folder_runs
    assert len(jp.dfb) == 3 and tproc.pipe.dfb == jp.dfb
    assert [c["trace"] for c in tproc.refine_chunks] == jp.dfb


def test_folder_noise_fully_used(folder_runs):
    tp = folder_runs[3].pipe
    assert all(not v for v in tp.noise.draws.values())
    assert all(tp.outputs_finite.values())
    # one kept loop per Stage-1 shape and per refinement batch size
    kinds = sorted(k[0] if isinstance(k[0], str) else "edm" for k in tp.loop_graphs)
    assert kinds == ["ddpm", "ddpm", "edm", "edm"]


# ------------------------------------------------------ bucket and keys
@pytest.mark.parametrize("hw,bucket", [((64, 64), 0), ((64, 64), 64),
                                       ((64, 128), 512), ((200, 130), 64),
                                       ((1024, 1088), 512), ((5, 7), 4)])
def test_bucket_pad_equals_jax(hw, bucket):
    x = np.random.default_rng(sum(hw)).random((*hw, 3)).astype(np.float32)
    got = tpipeline.bucket_pad(x, bucket)
    np.testing.assert_array_equal(got, jpipeline.bucket_pad(x, bucket))
    if bucket:
        assert got.shape[0] % bucket == 0 and got.shape[1] % bucket == 0
        np.testing.assert_array_equal(got[:hw[0], :hw[1]], x)


@pytest.mark.parametrize("size", [(224, 224), (256, 256), (224, 300),
                                  (1100, 700), (2048, 1536)])
@pytest.mark.parametrize("min_size,bucket", [(1024, 512), (1024, 0), (64, 128)])
def test_refine_group_key_equals_jax(size, min_size, bucket):
    img = Image.new("RGB", size)
    refine = dict(min_size=min_size, size_bucket=bucket)
    jself = types.SimpleNamespace(debug_tiny=False, cfg=JPipelineConfig(
        refine=JRefinementConfig(**refine)))
    tself = types.SimpleNamespace(cfg=PipelineConfig(
        refine=RefinementConfig(**refine)))
    want = jpipeline.ImageBatchProcessor._refine_group_key(jself, img)
    assert ImageBatchProcessor._refine_group_key(tself, img) == want


# ------------------------------------------------ loops kept across calls
def _port(work, draws, stage1=None, **refine):
    cfg = PipelineConfig(ckpt_dir=str(work / "none"), output_dir=str(work),
                         seed=1, no_llava=True, params_dtype="fp32",
                         stage1=Stage1Config(steps=STEPS1, **(stage1 or {})),
                         refine=RefinementConfig(min_size=64, **refine))
    return SuperResolutionPipeline(cfg, device="cpu", model_cfgs=TORCH_TINY,
                                   noise=ReplayNoise(draws))


def _lr(work, name, seed):
    p = work / f"{name}.png"
    Image.fromarray((np.random.default_rng(seed).random((2, 2, 3)) * 255)
                    .astype("uint8")).save(p)
    return p


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_stage1_loop_kept_across_calls(tmp_path, sampler):
    """A second Stage 1 of the same shape reuses the kept loop (the same
    object, its step run on) and gives a fresh pipeline's image."""
    steps = STEPS1 if sampler == "ddpm" else len(ddim_timesteps(STEPS1, 4))
    rng = np.random.default_rng(0)
    n1, n2 = (rng.standard_normal((steps + 1, 1, 16, 16, 3)).astype(np.float32)
              for _ in range(2))
    p1, p2 = _lr(tmp_path, "p1", 1), _lr(tmp_path, "p2", 2)
    stage1 = dict(sampler=sampler, ddim_steps=4, ddim_eta=0.5)
    kept = _port(tmp_path, {"stage1": [n1, n2]}, stage1)
    kept.run_stage1(str(p1))
    (loop,) = kept.loop_graphs.values()
    got = kept.run_stage1(str(p2))
    assert list(kept.loop_graphs.values()) == [loop]
    assert loop[1].calls == 2 * steps and kept.capture_s["stage1"] == 0
    fresh = _port(tmp_path, {"stage1": [n2]}, stage1).run_stage1(str(p2))
    np.testing.assert_array_equal(got, fresh)


def test_refinement_loop_kept_across_calls(tmp_path):
    """A second refinement of the same shape reuses the kept RestoreEDM
    loop (its threshold, cache and counter reset) and gives a fresh
    pipeline's image; the first-block cache hits in both calls."""
    steps = 4
    rng = np.random.default_rng(1)
    draws = lambda: {"vae_sample": [rng.standard_normal((1, 32, 32, 4)).astype(np.float32)],
                     "edm_init": [rng.standard_normal((1, 32, 32, 4)).astype(np.float32)],
                     "churn": [rng.standard_normal((steps, 1, 32, 32, 4)).astype(np.float32)]}
    d1, d2 = draws(), draws()
    both = {k: d1[k] + d2[k] for k in d1}
    sr = [Image.fromarray((np.random.default_rng(s).random((16, 16, 3)) * 255)
                          .astype("uint8")) for s in (5, 6)]
    refine = dict(edm_steps=steps, img_threshold=1e9, size_bucket=0)
    kept = _port(tmp_path, both, **refine)
    kept.run_refinement(sr[0], "one")
    (loop,) = kept.loop_graphs.values()
    got = np.asarray(kept.run_refinement(sr[1], "two"))
    assert list(kept.loop_graphs.values()) == [loop]
    assert loop.runners["first"].calls == 2 * steps
    assert kept.last_dfb["trace"].tolist() == [False] + [True] * (steps - 1)
    fresh = _port(tmp_path, d2, **refine)
    want = np.asarray(fresh.run_refinement(sr[1], "two"))
    np.testing.assert_array_equal(got, want)
    assert fresh.last_dfb["trace"].tolist() == kept.last_dfb["trace"].tolist()


def test_kept_loops_capture_once(tmp_path, monkeypatch):
    """With graphs on (a stub CUDA graph on the CPU), a pipeline's second
    Stage 1 and second refinement of the kept shapes capture nothing:
    every runner they use was captured in the first call, and their
    capture seconds are 0."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for mod in (sr3_diffusion, samplers):
        monkeypatch.setattr(mod, "use_graphs", lambda dev, graphs: True)
    _StubGraph.captures = 0
    steps, rng = 3, np.random.default_rng(2)
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)
    draws = {"stage1": [normal(STEPS1 + 1, 1, 16, 16, 3) for _ in range(2)],
             "vae_sample": [normal(1, 32, 32, 4) for _ in range(2)],
             "edm_init": [normal(1, 32, 32, 4) for _ in range(2)],
             "churn": [normal(steps, 1, 32, 32, 4) for _ in range(2)]}
    # img_threshold 0: every step a miss, so `first` and `rest` both run
    pipe = _port(tmp_path, draws, edm_steps=steps, img_threshold=0.0,
                 size_bucket=0)
    sr = Image.fromarray((np.random.default_rng(7).random((16, 16, 3)) * 255)
                         .astype("uint8"))
    captures = []
    for _ in range(2):
        pipe.run_stage1(str(_lr(tmp_path, "p", 3)))
        pipe.run_refinement(sr, "text")
        captures.append(_StubGraph.captures)
        if len(captures) == 1:
            assert pipe.capture_s["stage1"] > 0
    # SR3, then RestoreEDM's first and rest: three captures, all in call 1
    assert captures == [3, 3]
    assert pipe.capture_s["stage1"] == 0
    assert all(v == 0 for k, v in pipe.capture_s.items() if k.startswith("sampling_"))


# ------------------------------------------- the bucket's padding and crop
def _refine_noise(n, side):
    """The draws of one JAX _refine_core on a fresh pipeline key."""
    _, k_enc, k_noise, k_loop = jax.random.split(jax.random.PRNGKey(SEED), 4)
    shape = (n, side // 2, side // 2, 4)
    normal = lambda k: np.asarray(jax.random.normal(k, shape, jnp.float32))
    return {"vae_sample": [normal(k_enc)], "edm_init": [normal(k_noise)],
            "churn": [np.stack([normal(jax.random.fold_in(k_loop, i))
                                for i in range(EDM_STEPS)])]}


@pytest.mark.parametrize("batched", [True, False])
def test_refinement_bucket_pad_and_crop_equal_jax(folder_runs, batched):
    """size_bucket 128: a 64x64 and a 64x128 Stage-1 image (one bucketed
    key) padded by edge to 128x128, refined, cropped back and colour-fixed
    one by one, in one batch or (the second alone) through
    run_refinement(use_bucket=True): JAX's PNGs within 1 uint8 level."""
    _, jp, _, tproc, _ = folder_runs
    rng = np.random.default_rng(8)
    pils = [Image.fromarray((rng.random((64, w, 3)) * 255).astype("uint8"))
            for w in (64, 128)]
    items = list(zip(pils, ["a field", "a road"]))
    if not batched:
        items = items[1:]
    key = ImageBatchProcessor._refine_group_key(
        types.SimpleNamespace(cfg=PipelineConfig(refine=RefinementConfig(
            min_size=64, size_bucket=128))), pils[1])
    assert key == (128, 128)
    mp = pytest.MonkeyPatch()
    mp.setattr(jp.cfg.refine, "size_bucket", 128)
    jp.rng = jax.random.PRNGKey(SEED)
    traced = len(jp.dfb)
    try:
        want = (jp.run_refinement_batch(items) if batched
                else [jp.run_refinement(*items[0])])
    finally:
        mp.undo()
        del jp.dfb[traced:]  # the folder run's traces stay as recorded
    cfg = _cfg(TMOD, folder_runs[0], "bucket", llava=False)
    cfg.refine.size_bucket = 128
    tp = SuperResolutionPipeline(
        cfg, device="cpu", model_cfgs=TORCH_TINY,
        noise=ReplayNoise(_refine_noise(len(items), 128)),
        state_dicts={fam: getattr(tproc.pipe, fam).state_dict()
                     for fam in FAMILIES})
    got = (tp.run_refinement_batch(items) if batched
           else [tp.run_refinement(*items[0])])
    assert all(not v for v in tp.noise.draws.values())
    for (pil, _), a, b in zip(items, want, got):
        a, b = np.asarray(a, np.int16), np.asarray(b, np.int16)
        assert a.shape == b.shape == (pil.size[1], pil.size[0], 3)
        assert np.abs(a - b).max() <= 1 and a.std() > 0
