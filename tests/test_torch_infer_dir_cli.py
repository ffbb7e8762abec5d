"""The port's folder CLI, `python -m rsvldm_tpu_torch.infer_dir`, on the
CPU at the tiny geometries: a three-image folder (two Stage-1 shapes)
gives both output trees and "processed 3/3 images"; --stage1_only writes
Stage 1 alone; the flags reach the configuration; without --device cpu on
a machine with no card it raises."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu_torch import infer_dir

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
FAST = ["--device", "cpu", "--debug_tiny", "--stage1_sampler", "ddim",
        "--stage1_steps", "4", "--num_steps", "2"]


@pytest.fixture(scope="module")
def lr_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_folder")
    rng = np.random.default_rng(4)
    for name, side in (("a", 2), ("b", 3), ("c", 2)):
        Image.fromarray((rng.random((side, side, 3)) * 255).astype("uint8")
                        ).save(d / f"{name}.png")
    (d / "notes.txt").write_text("not an image")
    return d


def test_cli_folder_as_a_module(lr_dir, tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "rsvldm_tpu_torch.infer_dir", *FAST,
         "--image_dir", str(lr_dir), "--save_dir", str(tmp_path),
         "--ckpt_dir", str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "processed 3/3 images" in res.stdout
    for name, side in (("a", 2), ("b", 3), ("c", 2)):
        sr = np.asarray(Image.open(tmp_path / "sr3_output" / f"sr3_{name}.png"))
        fin = np.asarray(Image.open(tmp_path / "output" / f"{name}_final_0.png"))
        assert sr.shape == fin.shape == (8 * side, 8 * side, 3)
        assert sr.std() > 0 and fin.std() > 0


def test_cli_stage1_only(lr_dir, tmp_path, capsys):
    proc = infer_dir.main([*FAST, "--image_dir", str(lr_dir), "--save_dir",
                           str(tmp_path), "--ckpt_dir", str(tmp_path / "none"),
                           "--stage1_only"])
    assert "processed 3/3 images" in capsys.readouterr().out
    assert sorted(proc.statuses.values()) == ["stage1"] * 3
    assert proc.fallbacks == [] and not list((tmp_path / "output").glob("*.png"))
    assert len(list((tmp_path / "sr3_output").glob("sr3_*.png"))) == 3
    assert [g["n"] for g in proc.pipe.stage1_groups] == [2, 1]


def test_build_processor_flags():
    args = infer_dir.parse_args(["--image_dir", "d", "--save_dir", "o",
                                 "--num_steps", "7", "--img_threshold", "0.5",
                                 "--upscale", "4", "--seed", "3", "--quant",
                                 "int4", "--device", "cpu", "--stage1_sampler",
                                 "ddim", "--stage1_steps", "9", "--no_llava"])
    proc = infer_dir.build_processor(args)
    cfg = proc.cfg
    assert (cfg.image_dir, str(cfg.output_dir), cfg.upscale, cfg.seed) == (
        "d", "o", 4, 3)
    assert (cfg.refine.edm_steps, cfg.refine.img_threshold) == (7, 0.5)
    assert (cfg.stage1.sampler, cfg.stage1.ddim_steps) == ("ddim", 9)
    assert cfg.llava.quant == "int4" and cfg.no_llava
    assert (cfg.refine.min_size, cfg.refine.size_bucket) == (1024, 512)
    assert (proc.caption_batch, proc.refine_batch) == (8, 4)
    assert proc.pipe.device.type == "cpu"
    tiny = infer_dir.build_processor(infer_dir.parse_args(
        ["--image_dir", "d", "--device", "cpu", "--debug_tiny"]))
    assert (tiny.cfg.refine.min_size, tiny.cfg.refine.size_bucket) == (64, 64)
    assert tiny.cfg.no_llava


def test_cli_raises_without_a_card(lr_dir, tmp_path):
    """The default device is CUDA: on a machine without a card the CLI
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_dir.main(["--image_dir", str(lr_dir), "--save_dir",
                        str(tmp_path), "--debug_tiny"])
