"""The port's CLI, `python -m rsvldm_tpu_torch.infer`, on CPU: at the tiny
geometries it reads a checkpoint directory written at them (every family
from its files) and writes both PNGs, and runs Stage 1 as DDIM; without
--device cpu on a machine with no card it raises; --draft_dir and
--self_draft build a speculative captioner."""

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
sys.path.insert(0, str(REPO / "tests"))
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


def test_cli_stage1_ddim(tiny_ckpt, tmp_path):
    """--stage1_sampler ddim --stage1_steps 4: Stage 1 runs DDIM, drawing
    5 noise rows (x_T and one a step), and writes its PNG."""
    cd, _ = tiny_ckpt
    args = infer.parse_args(["--device", "cpu", "--debug_tiny", "--ckpt_dir",
                             str(cd), "--input_img", str(cd / "in.png"),
                             "--output_dir", str(tmp_path), "--stage1_only",
                             "--stage1_sampler", "ddim", "--stage1_steps", "4"])
    pipe = infer.build_pipeline(args)
    assert (pipe.cfg.stage1.sampler, pipe.cfg.stage1.ddim_steps) == ("ddim", 4)
    shapes = []
    draw = pipe.noise
    pipe.noise = lambda name, shape, **kw: shapes.append(shape) or draw(
        name, shape, **kw)
    pipe.process()
    assert shapes == [(5, 1, 16, 16, 3)]
    png = np.asarray(Image.open(tmp_path / "sr3_in.png"))
    assert png.shape == (16, 16, 3) and png.std() > 0


@pytest.mark.parametrize("flag", ["--draft_dir", "--self_draft"])
def test_cli_builds_a_speculative_captioner(tmp_path, flag):
    """--draft_dir D (a one-layer draft checkpoint with its config.json,
    tests/test_captioner.py's) and --self_draft 1 reach LlavaConfig, and the
    pipeline's captioner load builds a captioner with that draft (the
    captioner at test_captioner's geometry, as the port's pipeline tests
    load it)."""
    from safetensors.torch import save_file
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    import test_captioner as tc
    (tmp_path / "llava").mkdir()
    save_file(tc._tiny_llava_state_dict(),
              str(tmp_path / "llava" / "model.safetensors"))
    if flag == "--draft_dir":  # outside <ckpt_dir>, so found by name only
        (tmp_path / "drafts").mkdir()
        value = str(tc._write_draft_dir(tmp_path / "drafts", layers=1))
    else:
        value = "1"
    pipe = infer.build_pipeline(infer.parse_args(
        ["--input_img", "x.png", "--device", "cpu", "--debug_tiny",
         "--ckpt_dir", str(tmp_path), flag, value]))
    llava = pipe.cfg.llava
    assert (llava.draft_dir, llava.self_draft_layers) == (
        (value, 0) if flag == "--draft_dir" else ("", 1))
    pipe.llava_load_kw = dict(
        llama_cfg=LlamaConfig(vocab_size=256, dim=32, layers=2, heads=4,
                              kv_heads=2, ffn_dim=64),
        vision_cfg=CLIPVisionConfig(image_size=28, patch_size=14, width=24,
                                    layers=2, heads=2, select_layer=-2),
        tokenizer=tc.FakeTokenizer())
    pipe._load_llava()
    cap = pipe.llava
    assert cap is not None and cap.draft is not None
    if flag == "--draft_dir":
        assert cap.self_draft_layers == 0 and cap.draft.cfg.layers == 1
    else:
        assert cap.draft.model.layers[0] is cap.llama.model.layers[0]
