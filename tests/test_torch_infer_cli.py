"""The port's CLI, `python -m rsvldm_tpu_torch.infer`, on CPU: at the tiny
geometries it reads a checkpoint directory written at them (every family
from its files) and writes both PNGs; without --device cpu on a machine
with no card it raises; what is not ported yet raises."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu_torch import infer
from rsvldm_tpu_torch.pipeline import CHECKPOINTS
from rsvldm_tpu_torch.utils.weights import seeded_init_

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The reference layout at the tiny geometries, from seeded modules in
    bf16 (written by chip_smoke.write_safetensors and torch.save), and a
    tiny clip_vocab."""
    from rsvldm_tpu_torch.config import RefinementConfig
    from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNet
    from rsvldm_tpu_torch.models.text.clip import CLIPTextTransformer
    from rsvldm_tpu_torch.models.vae.model import AutoencoderKL
    cd = tmp_path_factory.mktemp("tiny_ckpt")
    cfgs = infer.tiny_model_cfgs()
    mods = {"sr3": SR3UNet(cfgs["sr3"]), "unet": ControlledUNet(cfgs["sdxl"]),
            "control": GLVControl(cfgs["sdxl"]), "vae": AutoencoderKL(cfgs["vae"]),
            "clip_l": CLIPTextTransformer(cfgs["clip_l"]),
            "big_g": CLIPTextTransformer(cfgs["big_g"])}
    sds = {fam: {k: v.to(torch.bfloat16) for k, v in
                 seeded_init_(m, fam, torch.device("cpu")).state_dict().items()}
           for fam, m in mods.items()}
    torch.save(sds["sr3"], cd / CHECKPOINTS["sr3"][0][0])
    jug, srq = {}, {}
    for fam in ("unet", "vae", "clip_l", "big_g", "control"):
        prefix = CHECKPOINTS[fam][1]
        dst = srq if fam == "control" else jug
        dst.update({f"{prefix}.{k}": v for k, v in sds[fam].items()})
    chip_smoke.write_safetensors(cd / CHECKPOINTS["unet"][0][0], jug)
    torch.save({"state_dict": srq}, cd / CHECKPOINTS["unet"][0][1])
    r = RefinementConfig()
    chip_smoke.ClipAssets([r.a_prompt, r.n_prompt], n_merges=300,
                          sot=998).write(cd / "clip_vocab")
    Image.fromarray((np.random.default_rng(3).random((2, 2, 3)) * 255)
                    .astype("uint8")).save(cd / "in.png")
    return cd, sds


def test_cli_reads_the_directory_and_writes_pngs(tiny_ckpt, tmp_path):
    cd, sds = tiny_ckpt
    args = ["--device", "cpu", "--debug_tiny", "--ckpt_dir", str(cd),
            "--input_img", str(cd / "in.png"), "--output_dir", str(tmp_path),
            "--edm_steps", "2"]
    pipe = infer.main(args)
    for fam in sds:
        assert isinstance(pipe.weight_sources[fam], list), fam
        got = getattr(pipe, fam).state_dict()
        assert all(torch.equal(got[k], v.float()) for k, v in sds[fam].items()), fam
    assert pipe.tokenizer is not None and pipe.llava is None
    for name in ("sr3_in.png", "in_final_0.png"):
        png = np.asarray(Image.open(tmp_path / name))
        assert png.shape == (16, 16, 3) and png.std() > 0


def test_cli_as_a_module(tiny_ckpt, tmp_path):
    """`python -m rsvldm_tpu_torch.infer` in its own process."""
    cd, _ = tiny_ckpt
    res = subprocess.run(
        [sys.executable, "-m", "rsvldm_tpu_torch.infer", "--device", "cpu",
         "--debug_tiny", "--ckpt_dir", str(cd), "--input_img", str(cd / "in.png"),
         "--output_dir", str(tmp_path), "--edm_steps", "1", "--stage1_only"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp_path / "sr3_in.png").exists()
    assert not (tmp_path / "in_final_0.png").exists()


def test_cli_raises_without_a_card(tiny_ckpt):
    """The default device is CUDA: on a machine without a card the CLI
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be shown")
    cd, _ = tiny_ckpt
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--input_img", str(cd / "in.png"), "--debug_tiny",
                    "--ckpt_dir", str(cd)])


@pytest.mark.parametrize("flags", [["--stage1_sampler", "ddim"],
                                   ["--draft_dir", "d"], ["--self_draft", "4"]])
def test_cli_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        infer.build_pipeline(infer.parse_args(
            ["--input_img", "x.png", "--device", "cpu"] + flags))
