"""The PyTorch port stands alone: importing it and every submodule loads
neither JAX nor any module of the JAX package, nor a package the card's
machine lacks (safetensors, transformers, tokenizers, regex, orbax), and its
entry points refuse to run on the CPU when they are asked for CUDA on a
machine without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import rsvldm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rsvldm_tpu_torch.__path__,
                                               "rsvldm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
absent = ("safetensors", "transformers", "tokenizers", "regex", "orbax",
          "sentencepiece")
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "rsvldm_tpu") + absent or m.startswith(
                 ("jax.", "jaxlib", "flax.", "rsvldm_tpu.")
                 + tuple(a + "." for a in absent)))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "rsvldm_tpu_torch.pipeline" in out["modules"]
    assert "rsvldm_tpu_torch.ops.flash_attention" in out["modules"]
    assert "rsvldm_tpu_torch.ops.quant" in out["modules"]
    assert "rsvldm_tpu_torch.models.vlm.captioner" in out["modules"]
    for name in ("training", "training.vlm_trainer", "training.vlm_data",
                 "data", "data.prefetch", "train_vlm", "infer", "infer_dir",
                 "utils.safetensors", "utils.checkpoint", "utils.tokenizer",
                 "models.vlm.tokenizer", "utils.graphs",
                 "models.vlm.speculative", "models.vlm.conversation",
                 "models.vae.tiled", "models.vlm.video", "train_sr3",
                 "training.sr3_trainer", "training.ema",
                 "training.lr_schedule", "training.losses",
                 "data.datasets", "serving", "serving.engine",
                 "serving.http_util", "serving.worker", "serving.llm_worker",
                 "serving.controller", "serving.web", "serving.cli",
                 "serving.register_worker", "serving.test_message",
                 "diffusion.brownian", "diffusion.samplers_extra",
                 "utils.counter", "utils.metrics", "utils.lpips",
                 "utils.debug", "utils.file", "utils.moderation",
                 "utils.run_logger", "utils.face_restore", "data.prepare",
                 "eval", "eval.text_metrics", "eval.runner",
                 "eval.interleave", "eval.quality", "eval_dir",
                 "models.vlm.mpt", "models.vlm.siglip", "models.vlm.eva_vit",
                 "models.vlm.towers", "models.vlm.projector",
                 "models.vlm.resampler", "models.text.t5",
                 "models.text.embedders", "parallel", "parallel.distributed",
                 "parallel.mesh", "parallel.llama_sharding"):
        assert f"rsvldm_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    from rsvldm_tpu_torch.config import PipelineConfig
    from rsvldm_tpu_torch.device import resolve_device
    from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuperResolutionPipeline(PipelineConfig(no_llava=True), device="cuda")
    from rsvldm_tpu_torch import train_vlm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vlm.main(["--smoke", "--data_path", "d.json", "--output_dir", "o"])
    from rsvldm_tpu_torch import train_sr3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_sr3.main(["--data_root", "d"])
    # the captioner's constructors default to the card
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    tiny = dict(llama_cfg=LlamaConfig(vocab_size=64, dim=32, layers=1, heads=4,
                                      kv_heads=2, ffn_dim=64),
                vision_cfg=CLIPVisionConfig(image_size=28, patch_size=14,
                                            width=24, layers=1, heads=2))
    for build in (lambda: LlavaCaptioner.seeded(**tiny, tokenizer=object()),
                  lambda: LlavaCaptioner.from_state_dict({}, **tiny),
                  lambda: LlavaCaptioner.load("no_such_dir", **tiny)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the other families' constructors (Gemma's tied head, MoE) and the
    # vision-tower registry, each before it builds anything
    import dataclasses
    from rsvldm_tpu_torch.models.vlm.towers import build_vision_tower
    gemma = dict(tiny, llama_cfg=dataclasses.replace(
        tiny["llama_cfg"], norm_plus_one=True, scale_embeds=True,
        tie_lm_head=True, act="gelu_tanh", head_dim_cfg=16))
    moe = dict(tiny, llama_cfg=dataclasses.replace(
        tiny["llama_cfg"], num_experts=4, shared_expert_dim=16))
    for build in (lambda: LlavaCaptioner.seeded(**gemma, tokenizer=object()),
                  lambda: LlavaCaptioner.seeded(**moe, tokenizer=object()),
                  lambda: build_vision_tower("openai/clip-vit-large-patch14-336"),
                  lambda: build_vision_tower("DeepGlint-AI/mlcd-vit-bigG-patch14-448"),
                  lambda: build_vision_tower("EVA02-CLIP-L-14-336")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the serving entry points: each main, before it reads anything
    from rsvldm_tpu_torch.serving import cli, llm_worker, worker
    for main, argv in ((llm_worker.main, ["--no-register", "--ckpt_dir", "c"]),
                       (worker.main, ["--no-register", "--ckpt_dir", "c"]),
                       (cli.main, ["--image-file", "i.png", "--ckpt_dir", "c"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    # the mesh entry points, each before it joins a process group or
    # builds anything
    from rsvldm_tpu_torch import infer_dir
    from rsvldm_tpu_torch.pipeline import ImageBatchProcessor
    for build in (lambda: LlavaCaptioner.seeded(**tiny, tokenizer=object(),
                                                mesh=object()),
                  lambda: SuperResolutionPipeline(PipelineConfig(no_llava=True),
                                                  device="cuda", mesh=object()),
                  lambda: ImageBatchProcessor(PipelineConfig(no_llava=True),
                                              device="cuda", mesh=object()),
                  lambda: infer_dir.main(["--image_dir", "d", "--mesh", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    import torch.distributed as dist
    assert not dist.is_initialized()
    # quality evaluation, the Brownian tree's default draws, the face
    # helper: each before it reads or draws anything
    from rsvldm_tpu_torch.diffusion.brownian import (BrownianTreeNoiseSampler,
                                                     CounterDraws)
    from rsvldm_tpu_torch.eval import quality
    from rsvldm_tpu_torch.utils.face_restore import FaceRestoreHelper
    for build in (lambda: quality.main(["--sr_dir", "no_such_dir"]),
                  lambda: quality.evaluate_dir("no_such_dir"),
                  lambda: CounterDraws(0),
                  lambda: BrownianTreeNoiseSampler(0.03, 14.6, (1, 4)),
                  lambda: FaceRestoreHelper(upscale_factor=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_caption_options_are_taken():
    """Every caption option of the JAX package's LlavaConfig is taken with
    its meaning: the speculative draft, its proposals a round, the
    self-draft's depth, and the archives; an unknown quant raises."""
    from rsvldm_tpu_torch.config import LlavaConfig
    cfg = LlavaConfig(draft_dir="d", spec_k=2, self_draft_layers=8)
    assert (cfg.draft_dir, cfg.spec_k, cfg.self_draft_layers) == ("d", 2, 8)
    cfg = LlavaConfig(lora_npz="a.npz", projector_npz="p.npz")
    assert (cfg.lora_npz, cfg.projector_npz) == ("a.npz", "p.npz")
    with pytest.raises(ValueError, match="quant"):
        LlavaConfig(quant="int2")
