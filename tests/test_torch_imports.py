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
absent = ("safetensors", "transformers", "tokenizers", "regex", "orbax")
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
                 "models.vae.tiled"):
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
