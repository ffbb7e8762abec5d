"""The port's checkpoint reading on CPU: its safetensors reader against the
`safetensors` package (every dtype, bit for bit, and the malformed files it
must refuse), chip_smoke.py's writer read back by that package,
load_torch_state_dict / strip_prefix / overlay against the JAX package's on
the same files, the load rule, and the full-width modules' names and shapes
against the published checkpoints' (tests/fixtures/convert_stats.json)."""

import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load
from safetensors.torch import save_file as st_save

from rsvldm_tpu.utils import checkpoint as jckpt
from rsvldm_tpu_torch.utils import checkpoint as ckpt
from rsvldm_tpu_torch.utils.safetensors import SafetensorsError, load_file

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


def _tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        x = torch.randn(3, 5, 7, generator=g) * 100
        out[f"t{i}.{str(dt)[6:]}"] = (x > 0) if dt == torch.bool else x.to(dt)
        out[f"scalar.{i}"] = torch.tensor(3.5).to(dt)
        out[f"empty.{i}"] = torch.zeros((0, 4), dtype=dt)
    out["odd.bytes"] = torch.arange(3, dtype=torch.uint8)  # misaligns the rest
    out["after_odd"] = torch.randn(4, 9, generator=g)
    return out


def _assert_bit_equal(got, want):
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.reshape(-1).view(torch.uint8) if g.numel() else g,
                           w.reshape(-1).view(torch.uint8) if w.numel() else w), k


def test_reader_matches_safetensors_package(tmp_path):
    tensors = _tensors()
    st_save(tensors, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got = load_file(tmp_path / "a.safetensors")
    _assert_bit_equal(got, st_load(str(tmp_path / "a.safetensors")))
    _assert_bit_equal(got, tensors)
    got["t1.float32"].fill_(0)  # copy-on-write: the file does not change
    _assert_bit_equal(load_file(tmp_path / "a.safetensors"), tensors)


def test_chip_smoke_writer_read_by_package(tmp_path):
    tensors = _tensors()
    n = chip_smoke.write_safetensors(tmp_path / "w.safetensors", tensors,
                                     metadata={"format": "pt"})
    assert n == (tmp_path / "w.safetensors").stat().st_size
    _assert_bit_equal(st_load(str(tmp_path / "w.safetensors")), tensors)
    _assert_bit_equal(load_file(tmp_path / "w.safetensors"), tensors)


def _raw(path, header, data=b""):
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + data)
    return path


@pytest.mark.parametrize("case", ["dtype", "overlap", "past_end", "length",
                                  "truncated_header", "no_length"])
def test_reader_refuses_malformed(tmp_path, case):
    p = tmp_path / "bad.safetensors"
    ok = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "dtype":
        _raw(p, {"a": dict(ok, dtype="F8_E4M3")}, bytes(8))
    elif case == "overlap":
        _raw(p, {"a": dict(ok, shape=[3], data_offsets=[0, 12]),
                 "z": dict(ok, shape=[0], data_offsets=[4, 4]),
                 "b": dict(ok, data_offsets=[8, 16])}, bytes(16))
    elif case == "past_end":  # a file cut short
        _raw(p, {"a": ok, "b": dict(ok, data_offsets=[8, 16])}, bytes(12))
    elif case == "length":
        _raw(p, {"a": dict(ok, data_offsets=[0, 4])}, bytes(8))
    elif case == "truncated_header":
        p.write_bytes(struct.pack("<Q", 100) + b'{"a": ')
    else:
        p.write_bytes(b"\x01\x02")
    with pytest.raises(SafetensorsError):
        load_file(p)


def _sd(seed, names, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(4, 3, generator=g).to(dtype) for n in names}


def test_load_strip_overlay_equal_jax(tmp_path):
    """The same three files through both packages' load_torch_state_dict,
    overlay and strip_prefix give the same names and values."""
    base = _sd(1, ["m.a.weight", "m.b.weight", "first_stage_model.x", "other"],
               torch.float16)
    st_save(base, str(tmp_path / "base.safetensors"))
    over = _sd(2, ["m.b.weight", "m.c.weight"])
    torch.save({"state_dict": over, "epoch": 3}, tmp_path / "over.ckpt")
    plain = _sd(3, ["p.q"])
    torch.save(plain, tmp_path / "plain.pth")
    files = [tmp_path / n for n in ("base.safetensors", "over.ckpt", "plain.pth")]
    mine = [ckpt.load_torch_state_dict(p) for p in files]
    theirs = [jckpt.load_torch_state_dict(str(p)) for p in files]
    for m, t in zip(mine, theirs):
        assert sorted(m) == sorted(t)
        for k in m:
            np.testing.assert_array_equal(m[k].float().numpy(),
                                          np.asarray(torch.as_tensor(t[k]).float()))
    merged, jmerged = ckpt.overlay(*mine), jckpt.overlay(*theirs)
    assert list(merged) == list(jmerged)
    assert torch.equal(merged["m.b.weight"], over["m.b.weight"])  # later wins
    got, want = ckpt.strip_prefix(merged, "m"), jckpt.strip_prefix(jmerged, "m")
    assert sorted(got) == sorted(want) == ["a.weight", "b.weight", "c.weight"]


def test_load_checked_rule():
    """Missing names and other shapes raise; extra names are skipped; the
    values are cast into the module's dtype."""
    mod = torch.nn.Linear(3, 4).to(torch.bfloat16)
    sd = {"weight": torch.randn(4, 3), "bias": torch.randn(4),
          "position_ids": torch.arange(4)}
    ckpt.load_checked(mod, sd, "linear")
    assert mod.weight.dtype == torch.bfloat16
    assert torch.equal(mod.weight, sd["weight"].to(torch.bfloat16))
    with pytest.raises(KeyError, match="lacks 1"):
        ckpt.load_checked(mod, {"weight": sd["weight"]}, "linear")
    with pytest.raises(ValueError, match="shapes differ"):
        ckpt.load_checked(mod, dict(sd, bias=torch.randn(5)), "linear")


def test_full_width_modules_have_the_published_names():
    """The port's SR3, VAE (with denoise_encoder), GLVControl and controlled
    UNet at full width, built on the meta device: names and shapes equal to
    the published checkpoints' key lists."""
    from rsvldm_tpu_torch.models.sdxl.control import ControlledUNet, GLVControl
    from rsvldm_tpu_torch.models.sdxl.unet import SDXLUNetConfig
    from rsvldm_tpu_torch.models.sr3.unet import SR3UNet, SR3UNetConfig
    from rsvldm_tpu_torch.models.vae.model import SDXL_VAE_CONFIG, AutoencoderKL
    stats = json.loads((Path(__file__).parent / "fixtures" /
                        "convert_stats.json").read_text())
    with torch.device("meta"):
        mods = {"sr3": SR3UNet(SR3UNetConfig()), "vae": AutoencoderKL(SDXL_VAE_CONFIG),
                "control": GLVControl(SDXLUNetConfig()),
                "unet": ControlledUNet(SDXLUNetConfig())}
    want = {"sr3": stats["sr3"]["keys"], "vae": stats["vae"]["keys"],
            "control": stats["xl"]["control_keys"], "unet": stats["xl"]["unet_keys"]}
    for fam, mod in mods.items():
        got = {k: list(t.shape) for k, t in mod.state_dict().items()}
        assert got == want[fam], fam
    assert any(k.startswith("denoise_encoder.") for k in want["vae"])
