"""The port's small utilities held against the JAX package's on the CPU:
debug (NaN guards, finite checks over nested state, the stage timer, the
profiler scope), file (listing, the URL cache on file:// URLs, the delta /
merge tools on torch state dicts), run_logger, moderation (urlopen mocked:
nothing reaches the network) and prepare_triplets (its files byte-equal to
JAX's)."""

import json
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.data.prepare import prepare_triplets as j_prepare
from rsvldm_tpu.utils import file as J_file
from rsvldm_tpu.utils import moderation as J_mod
from rsvldm_tpu.utils.run_logger import RunLogger as JRunLogger
from rsvldm_tpu_torch.data.prepare import prepare_triplets
from rsvldm_tpu_torch.utils import debug as D
from rsvldm_tpu_torch.utils import file as T_file
from rsvldm_tpu_torch.utils import moderation as T_mod
from rsvldm_tpu_torch.utils.run_logger import RunLogger

torch.set_num_threads(1)


# ------------------------------------------------------------------ debug

@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf"), None])
def test_for_nans_raises_on_any_non_finite(bad):
    x = torch.randn(4, 5)
    if bad is None:
        D.test_for_nans(x, "vae")  # finite: no exception
        return
    x[2, 3] = bad
    with pytest.raises(D.NansException, match="vae"):
        D.test_for_nans(x, "vae")


def test_tree_finite_over_nested_state():
    sd = {"a": torch.ones(3), "b": {"c": [torch.zeros(2), torch.arange(4)],
                                    "d": (torch.ones(1, dtype=torch.bfloat16),)},
          "n": 3, "s": "text"}
    assert D.tree_finite(sd)
    sd["b"]["c"][0][1] = float("nan")
    assert not D.tree_finite(sd)
    assert D.tree_finite({"i": torch.tensor([1, 2])})
    assert not D.tree_finite(torch.tensor([float("inf")]))


def test_stage_timer_records_seconds(caplog):
    with caplog.at_level(logging.INFO, logger="rsvldm_torch"):
        with D.stage_timer("unit") as t:
            t["out"] = torch.ones(3) * 2
    assert t["seconds"] >= 0.0
    assert any("[unit]" in r.getMessage() for r in caplog.records)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with D.profile_trace(str(tmp_path / "prof")):
        torch.mm(torch.randn(16, 16), torch.randn(16, 16))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


# ------------------------------------------------------------------- file

def test_list_files_equals_jax(tmp_path):
    (tmp_path / "a.png").write_bytes(b"x")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.JPG").write_bytes(b"x")
    (tmp_path / "c.txt").write_bytes(b"x")
    for kw in ({}, {"recursive": False}, {"suffixes": (".txt",)}):
        assert T_file.list_files(tmp_path, **kw) == J_file.list_files(tmp_path, **kw)
    assert len(T_file.list_files(tmp_path)) == 2


def test_load_file_from_url_cache(tmp_path):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"abc123")
    out = T_file.load_file_from_url(src.as_uri(), model_dir=str(tmp_path / "cache"))
    assert open(out, "rb").read() == b"abc123"
    src.write_bytes(b"CHANGED")  # cached: no second fetch
    out2 = T_file.load_file_from_url(src.as_uri(), model_dir=str(tmp_path / "cache"))
    assert out2 == out and open(out2, "rb").read() == b"abc123"
    named = T_file.load_file_from_url(src.as_uri(), model_dir=str(tmp_path / "cache"),
                                      file_name="renamed.bin")
    assert named.endswith("renamed.bin")
    assert out == J_file.load_file_from_url(src.as_uri(),
                                            model_dir=str(tmp_path / "cache"))


def _state_dicts():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    base = {"model.embed_tokens.weight": r(10, 4), "model.layers.0.w": r(4, 4),
            "lm_head.weight": r(10, 4)}
    target = {"model.embed_tokens.weight": r(12, 4),  # 2 more tokens
              "model.layers.0.w": r(4, 4).bfloat16(), "lm_head.weight": r(12, 4),
              "model.mm_projector.weight": r(4, 4)}
    return base, target


def test_delta_tools_equal_jax():
    base, target = _state_dicts()
    delta = T_file.make_delta(base, target)
    jdelta = J_file.make_delta(base, target)
    assert delta.keys() == jdelta.keys()
    for k in delta:
        assert delta[k].dtype == torch.float32
        np.testing.assert_array_equal(delta[k].numpy(), jdelta[k])
    back = T_file.apply_delta(base, delta)
    jback = J_file.apply_delta(base, jdelta)
    for k in target:
        np.testing.assert_array_equal(back[k].numpy(), jback[k])
        np.testing.assert_allclose(back[k].numpy(), target[k].float().numpy(),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="mismatch"):
        T_file.apply_delta(base, {"model.layers.0.w": torch.zeros(3, 3)})
    with pytest.raises(KeyError):
        T_file.make_delta(base, {"model.extra.w": torch.zeros(2)})
    sd = {"base_model.model.model.layers.0.w": 1, "other": 2,
          "x.base_model.model.y": 3}
    assert T_file.consolidate(sd) == J_file.consolidate(sd)
    assert T_file.consolidate(sd, ("other",)) == J_file.consolidate(sd, ("other",))


# ------------------------------------------------------------- run logger

def test_run_logger_equals_jax(tmp_path):
    recs = {}
    for name, cls in (("torch", RunLogger), ("jax", JRunLogger)):
        lg = cls(tmp_path / name / "log.jsonl", run_name="r")
        out = [lg.log(step=1, loss=torch.tensor(0.5), lr=1e-4),
               lg.log(note="text", acc=np.float32(0.25)), lg.log(step=2.0)]
        recs[name] = (out, lg.read())
    strip = lambda rs: [{k: v for k, v in r.items() if k != "t"} for r in rs]
    for a, b in zip(recs["torch"], recs["jax"]):
        assert strip(a) == strip(b)
    assert RunLogger(tmp_path / "none.jsonl").read() == []


# ------------------------------------------------------------- moderation

class _Resp:
    def __init__(self, body: bytes):
        self._body = body

    def read(self):
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("reply", ["flagged", "clean", "down", "not_json",
                                   "no_results", "no_key"])
def test_moderation_equals_jax(monkeypatch, reply):
    if reply == "no_key":
        monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    else:
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    seen = []

    def fake_urlopen(req, timeout):
        seen.append((req.full_url, req.get_header("Authorization"),
                     json.loads(req.data), timeout))
        if reply == "down":
            raise OSError("down")
        body = {"flagged": {"results": [{"flagged": True}]},
                "clean": {"results": [{"flagged": False}]},
                "no_results": {"unexpected": 1}}.get(reply)
        return _Resp(b"not json" if body is None else json.dumps(body).encode())

    got = T_mod.violates_moderation("bad\ntext", timeout=2.5, _urlopen=fake_urlopen)
    want = J_mod.violates_moderation("bad\ntext", timeout=2.5, _urlopen=fake_urlopen)
    assert got is want is (reply == "flagged")
    if reply != "no_key":
        assert seen[0] == seen[1] == (T_mod.MODERATION_URL, "Bearer sk-test",
                                      {"input": "badtext"}, 2.5)
    assert T_mod.MODERATION_URL == J_mod.MODERATION_URL
    assert T_mod.moderation_msg == J_mod.moderation_msg


# ---------------------------------------------------------------- prepare

def test_prepare_triplets_files_equal_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((40, 40), (30, 50), (64, 33))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            src / f"img{i}.png")
    (src / "notes.txt").write_text("x")
    done = prepare_triplets(str(src), str(tmp_path / "t"), l_res=4, r_res=16,
                            workers=2)
    jdone = j_prepare(str(src), str(tmp_path / "j"), l_res=4, r_res=16, workers=2)
    assert done == jdone == ["img0.png", "img1.png", "img2.png"]
    for d in ("hr_16", "lr_4", "sr_4_16"):
        for n in done:
            assert ((tmp_path / "t" / d / n).read_bytes()
                    == (tmp_path / "j" / d / n).read_bytes()), (d, n)
