"""Whole runs of the port from the seed alone, nothing injected, held
against the same runs of the JAX package: both pipelines' process() at
params_dtype fp32 with no checkpoint (each draws Flax's init from its
crc32 keys; no_llava, tiny geometry), the `train_vlm --smoke` recipes
(the decoder, projector and stand-in features each CLI draws from its own
keys) and `train_sr3` from --seed (Flax's init of PRNGKey(seed))."""

import dataclasses
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.models.sr3 as jsr3_pkg
import rsvldm_tpu.parallel
from rsvldm_tpu.config import (PipelineConfig as JPipelineConfig,
                               RefinementConfig as JRefinementConfig,
                               Stage1Config as JStage1Config)
from rsvldm_tpu.pipeline import SuperResolutionPipeline as JPipeline
from rsvldm_tpu.utils.checkpoint import load_orbax
from rsvldm_tpu_torch import train_sr3
from rsvldm_tpu_torch import train_vlm as ttrain
from rsvldm_tpu_torch.config import (PipelineConfig, RefinementConfig,
                                     Stage1Config)
from rsvldm_tpu_torch.pipeline import SuperResolutionPipeline
from rsvldm_tpu_torch.training.vlm_trainer import load_lora_npz
from rsvldm_tpu_torch.utils.weights import params_from_jax
from test_torch_sr3_train import L, R, _write_lrhr
from test_torch_train_cli import _recipe_data
from torch_parity_lib import JAX_TINY, TORCH_TINY, to_np

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SEED, STEPS1, EDM_STEPS = 7, 8, 2


def _cfg(mod, ckpt, out):
    return mod[0](ckpt_dir=str(ckpt), output_dir=str(out), upscale=8,
                  seed=SEED, params_dtype="fp32", no_llava=True,
                  stage1=mod[1](steps=STEPS1),
                  refine=mod[2](min_size=64, edm_steps=EDM_STEPS, size_bucket=0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """process() of both pipelines, each with its own seeded weights."""
    work = tmp_path_factory.mktemp("torch_seeded_runs")
    Image.fromarray((np.random.default_rng(3).random((2, 2, 3)) * 255)
                    .astype("uint8")).save(work / "in.png")
    jp = JPipeline(_cfg((JPipelineConfig, JStage1Config, JRefinementConfig),
                        work / "no_ckpt", work / "jax"), model_cfgs=JAX_TINY)
    jp.process(str(work / "in.png"))
    tp = SuperResolutionPipeline(
        _cfg((PipelineConfig, Stage1Config, RefinementConfig),
             work / "no_ckpt", work / "torch"), device="cpu",
        model_cfgs=TORCH_TINY)
    tp.process(str(work / "in.png"))
    return work, jp, tp


@pytest.mark.parametrize("name", ["sr3_in.png", "in_final_0.png"])
def test_seeded_pngs_within_one_level(runs, name):
    """Nothing injected: the same seed gives both pipelines the same
    weights, so the PNGs agree within 1 uint8 level."""
    work, _, tp = runs
    a = np.asarray(Image.open(work / "jax" / name), np.int16)
    b = np.asarray(Image.open(work / "torch" / name), np.int16)
    assert a.shape == b.shape == (16, 16, 3)
    assert a.std() > 0
    assert np.abs(a - b).max() <= 1
    assert all(v == "seeded" for k, v in tp.weight_sources.items())


def test_seeded_weights_and_cache_decisions_equal(runs):
    """Every family's seeded weights equal JAX's (Flax's init; draws within
    1e-6, zeros and ones exact), and the first-block cache decides alike."""
    _, jp, tp = runs
    cfgs = {"sr3": TORCH_TINY["sr3"], "unet": TORCH_TINY["sdxl"],
            "control": TORCH_TINY["sdxl"], "vae": TORCH_TINY["vae"],
            "clip_l": TORCH_TINY["clip_l"], "big_g": TORCH_TINY["big_g"]}
    for fam, cfg in cfgs.items():
        want = params_from_jax(fam, to_np(getattr(jp, f"{fam}_params")), cfg)
        got = getattr(tp, fam).state_dict()
        for k, w in want.items():
            err = (got[k] - w).abs() / w.abs().clamp_min(1.0)
            assert float(err.max()) <= 1e-6, (fam, k)
    np.testing.assert_array_equal(tp.last_dfb["trace"],
                                  np.asarray(jp.last_dfb["trace"]))
    assert tp.last_dfb["hits"] == jp.last_dfb["hits"]


def _smoke_cli(tmp_path, capsys, recipe):
    """(the root train_vlm.py --smoke's result, the common flags)."""
    sys.path.insert(0, str(REPO))
    import train_vlm as jcli
    flags = _recipe_data(tmp_path, recipe)
    common = ["--smoke", "--data_path", str(tmp_path / "train.json"),
              "--epochs", "3", "--steps", "3", "--batch_size", "2",
              "--pad_to", "64", "--bits", "8",
              "--num_workers", "0", "--seed", "1", *flags]
    jcli.main([*common, "--output_dir", str(tmp_path / "jax")])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), common


@pytest.mark.parametrize("recipe", ["projector", "lora,projector", "video",
                                    "lora"])
def test_cli_smoke_recipes_from_the_seed(tmp_path, monkeypatch, capsys,
                                         recipe):
    """The root train_vlm.py --smoke and the port's CLI, each from its own
    keys (its smoke decoder, adapters, projector and stand-in features):
    printed first and final losses within 1e-5, archives within 1e-4."""
    monkeypatch.setenv("RSVLDM_COMPILE_CACHE", "0")
    want, common = _smoke_cli(tmp_path, capsys, recipe)
    ttrain.main([*common, "--output_dir", str(tmp_path / "port"),
                 "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["steps"] == want["steps"] == 3
    for k in ("first_loss", "final_loss"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert ("adapters" in got) == ("adapters" in want)
    if "adapters" in want:
        gl, gcfg = load_lora_npz(got["adapters"])
        wl, wcfg = load_lora_npz(want["adapters"])
        assert gcfg == wcfg
        for p, ab in wl.items():
            for n in ("a", "b"):
                np.testing.assert_allclose(gl[p][n].numpy(), ab[n].numpy(),
                                           atol=1e-4, rtol=0)
    assert ("projector" in got) == ("projector" in want)
    if "projector" in want:
        gp, wp = np.load(got["projector"]), np.load(want["projector"])
        assert sorted(gp.files) == sorted(wp.files)
        for k in wp.files:
            np.testing.assert_allclose(gp[k], wp[k], atol=1e-4, rtol=0)


def _jax_dpo_near(tmp_path, capsys, common):
    """The root CLI's DPO smoke run on two decoders within one ulp of its
    own: the jitted Flax init (which parts from the CLI's eager one in
    about 10^4 embedding values) and the CLI's own moved by one ulp in
    about 10^4 embedding values (default_rng(1)'s choice). {name: (the
    printed result, the largest distance from the CLI's decoder in
    ulps)}."""
    import jax
    import jax.numpy as jnp
    import train_vlm as jcli
    from rsvldm_tpu.models.vlm.llama import KVCache
    cfg, model, params, encode, pre_kw = jcli._smoke_setup()
    emb = np.asarray(params["params"]["embed_tokens"]["embedding"])
    rng = np.random.default_rng(1)
    at = rng.random(emb.shape) < 10026 / emb.size
    to = np.where(rng.random(emb.shape) < 0.5, np.inf, -np.inf)
    moved = {"params": dict(params["params"], embed_tokens={
        "embedding": jnp.asarray(np.where(at, np.nextafter(
            emb, to.astype(np.float32)), emb))})}
    jitted = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 4), jnp.int32), KVCache.init(cfg, 1, 8), 0,
        method=model.from_tokens))(jax.random.PRNGKey(0))
    setup, runs = jcli._smoke_setup, {}
    try:
        for name, p in (("jitted", jitted), ("moved", moved)):
            jcli._smoke_setup = lambda: (cfg, model, p, encode, pre_kw)
            jcli.main([*common, "--output_dir", str(tmp_path / name)])
            e = np.asarray(p["params"]["embed_tokens"]["embedding"])
            runs[name] = (json.loads(capsys.readouterr().out.strip()
                                     .splitlines()[-1]),
                          int(np.abs(e.view(np.int32).astype(np.int64)
                                     - emb.view(np.int32)).max()))
    finally:
        jcli._smoke_setup = setup
    return runs


def test_cli_smoke_dpo_from_the_seed(tmp_path, monkeypatch, capsys):
    """The DPO smoke recipe from the seed against the root CLI. The port's
    seeded smoke decoder is the root CLI's (train_vlm._smoke_setup) within
    1e-6, and its first loss is within 1e-5 of the CLI's. Its final loss
    and adapters are held, within 1e-5 and 1e-4, to the root CLI's run on
    that decoder or on a decoder within one ulp of it: the third loss
    turns on one int8 activation code whose x / scale lies within an ulp
    of a round-half tie, which JAX's own CLI rounds either way under such
    a move (0.652058 / 0.653235)."""
    from rsvldm_tpu_torch.device import compute_dtype
    import train_vlm as jcli
    monkeypatch.setenv("RSVLDM_COMPILE_CACHE", "0")
    want0, common = _smoke_cli(tmp_path, capsys, "dpo")
    cpu = torch.device("cpu")
    dec = ttrain.smoke_captioner(None, cpu, compute_dtype(cpu))
    want_sd = params_from_jax("llama", to_np(jcli._smoke_setup()[2]),
                              ttrain.SMOKE_LLAMA)
    got_sd = dec.llama.state_dict()
    for k, w in want_sd.items():
        err = (got_sd[k] - w).abs() / w.abs().clamp_min(1.0)
        assert float(err.max()) <= 1e-6, k
    near = _jax_dpo_near(tmp_path, capsys, common)
    assert {k: u for k, (_, u) in near.items()} == {"jitted": 1, "moved": 1}
    ttrain.main([*common, "--output_dir", str(tmp_path / "port"),
                 "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["steps"] == want0["steps"] == 3
    assert abs(got["first_loss"] - want0["first_loss"]) <= 1e-5
    finals = {"cli": want0["final_loss"],
              **{k: r["final_loss"] for k, (r, _) in near.items()}}
    want = min((want0, *(r for r, _ in near.values())),
               key=lambda r: abs(r["final_loss"] - got["final_loss"]))
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-5, (
        got["final_loss"], finals)
    gl, gcfg = load_lora_npz(got["adapters"])
    wl, wcfg = load_lora_npz(want["adapters"])
    assert gcfg == wcfg
    for p, ab in wl.items():
        for n in ("a", "b"):
            np.testing.assert_allclose(gl[p][n].numpy(), ab[n].numpy(),
                                       atol=1e-4, rtol=0)


def test_train_sr3_from_the_seed_equals_jax(tmp_path, monkeypatch, capsys):
    """The root train_sr3.py (tiny SR3 config patched in, one device) and
    the port's `train_sr3 --debug_tiny --device cpu` at the same --seed,
    nothing fed: Flax's init of PRNGKey(seed) on both sides, the printed
    losses within 1e-5 (plus the 5-decimal rounding) and the saved UNet
    within 1e-4 after three steps."""
    root = _write_lrhr(tmp_path / "data", n=11)
    jcfg = JAX_TINY["sr3"]
    monkeypatch.setattr(jsr3_pkg, "SR3UNetConfig",
                        lambda image_size: dataclasses.replace(
                            jcfg, image_size=image_size))
    monkeypatch.setenv("RSVLDM_COMPILE_CACHE", "0")
    monkeypatch.setattr(rsvldm_tpu.parallel, "make_mesh", lambda **kw: None)
    common = ["--data_root", str(root), "--l_res", str(L), "--r_res", str(R),
              "--batch_size", "8", "--log_every", "1", "--num_workers", "0",
              "--seed", "4", "--steps", "3"]
    sys.path.insert(0, str(REPO))
    import train_sr3 as jcli
    monkeypatch.setattr(sys, "argv", ["train_sr3.py", *common, "--save_dir",
                                      str(tmp_path / "jax")])
    jcli.main()
    pat = r"step \d+: loss ([0-9.]+)"
    want = [float(x) for x in re.findall(pat, capsys.readouterr().out)]
    train_sr3.main([*common, "--debug_tiny", "--device", "cpu", "--save_dir",
                    str(tmp_path / "port")])
    got = [float(x) for x in re.findall(pat, capsys.readouterr().out)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 + 5e-6
    jparams = params_from_jax("sr3", to_np(load_orbax(tmp_path / "jax" /
                                                      "I3_gen")),
                              TORCH_TINY["sr3"])
    saved = torch.load(tmp_path / "port" / "I3_gen.pth", weights_only=True)
    for k, v in jparams.items():
        np.testing.assert_allclose(saved[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-5)
