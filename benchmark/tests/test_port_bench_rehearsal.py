"""The run's control flow rehearsed on the CPU at a tiny geometry
(tests/tiny.json: every width cut, a few steps, biases and norm weights
drawn with a spread): the port against the reference stage by stage for
each configuration's decoder knobs, the control one precision below in
the program's place coming out not correct, and the timed path broken
underneath (a loop step that leaves its state unchanged, a caption token
altered where it is sampled, the final image altered where it is made,
the decoder's q/k/v biases or its norms' scales dropped) coming out not
correct. No metric is written off the card, and run.py itself refuses to
run without one."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import manifest
from harness.cell import run_cell

BENCH = Path(manifest.__file__).resolve().parent.parent
TINY = json.loads((BENCH / "tests" / "tiny.json").read_text())
# the decoder knobs of each configuration, at tiny widths
KNOBS = {"rsvldm-mistral-7b": {"attention_bias": False, "rms_norm_eps": 1e-5,
                               "rope_theta": 1e6},
         "rsvldm-qwen2-7b": {"attention_bias": True, "rms_norm_eps": 1e-6,
                             "rope_theta": 1e6}}


def _spec(knobs="rsvldm-mistral-7b"):
    spec = json.loads(json.dumps(TINY))
    spec["text_config"].update(KNOBS[knobs])
    return spec


def _mix(no_llava=False):
    mix = manifest.traffic("image-nocaption" if no_llava else "image")
    mix["tile_side"] = 4
    return mix


def _run(tmp_path, spec, mix, control=False):
    return run_cell(spec, mix, {"name": "tiny"}, [{"name": "image_s",
                                                  "unit": "s"}],
                    2 ** 31 + 12345, 0.0, False, time.perf_counter(),
                    device="cpu", control=control, work=tmp_path)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_port_equals_reference_stage_by_stage(tmp_path, knobs):
    result, checks, extra = _run(tmp_path, _spec(knobs), _mix())
    assert result["correct"]
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert [n for n, _, _ in checks] == ["sr3_rms", "caption_gap", "final_rms"]
    for name, value, limit in checks:
        assert value <= 1e-6, (name, value)
    assert extra["cache_decisions_apart"] == 0


def test_no_caption_cell(tmp_path):
    result, checks, _ = _run(tmp_path, _spec(), _mix(no_llava=True))
    assert result["correct"]
    assert [n for n, _, _ in checks] == ["sr3_rms", "final_rms"]


def test_control_is_not_correct(tmp_path):
    result, checks, extra = _run(tmp_path, _spec(), _mix(), control=True)
    assert result["correct"] is False
    assert [n for n, _, _ in checks] == ["sr3_rms", "caption_gap", "final_rms"]
    for name, value, limit in checks:
        assert value > limit, name
        assert extra["program_" + name] <= 1e-6, name


def _unchanged_sr3_step(diff, model, lt):
    def step():
        lt.i.add_(1)
    return step


def _argmin_sample(lg, g, temp):
    return torch.argmin(lg.float() / temp + g, dim=-1)


def _unscaled_norm(self, x):
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
    return n.to(x.dtype)


# fault: (module, attribute, replacement, configuration knobs, the number
# that has to fail); a replacement of None adds 0.4 to the original's output
FAULTS = {
    "sr3_step_unchanged": ("rsvldm_tpu_torch.models.sr3.diffusion",
                           "_ancestral", _unchanged_sr3_step,
                           "rsvldm-mistral-7b", "sr3_rms"),
    "caption_token_altered": ("rsvldm_tpu_torch.models.vlm.generate",
                              "_sample", _argmin_sample, "rsvldm-mistral-7b",
                              "caption_gap"),
    "final_image_altered": ("rsvldm_tpu_torch.ops.colorfix",
                            "wavelet_reconstruction", None,
                            "rsvldm-mistral-7b", "final_rms"),
    "qkv_bias_dropped": ("rsvldm_tpu_torch.models.vlm.llama", "_add_bias",
                         lambda mod, y: y, "rsvldm-qwen2-7b", "caption_gap"),
    "norm_scale_dropped": ("rsvldm_tpu_torch.models.vlm.llama.RMSNorm",
                           "forward", _unscaled_norm, "rsvldm-mistral-7b",
                           "caption_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    import importlib
    mod_name, attr, fn, knobs, number = FAULTS[fault]
    owner = mod_name.rpartition(".")[2]
    if owner[0].isupper():
        mod = getattr(importlib.import_module(mod_name.rpartition(".")[0]),
                      owner)
    else:
        mod = importlib.import_module(mod_name)
    if fn is None:
        orig = getattr(mod, attr)
        fn = lambda c, s: orig(c, s) + 0.4  # noqa: E731
    monkeypatch.setattr(mod, attr, fn)
    result, checks, _ = _run(tmp_path, _spec(knobs), _mix())
    assert result["correct"] is False
    by = {n: (v, lim) for n, v, lim in checks}
    assert by[number][0] > by[number][1]


def test_run_without_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "mistral-7b.image", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(BENCH)})
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
