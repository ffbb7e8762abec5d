"""The port's quality evaluation (rsvldm_tpu_torch/eval, utils/metrics.py,
utils/lpips.py, models/vlm/vision.py::CLIPVisionEmbedder) held against the
JAX package's on the CPU, fp32, with the same weights and images:
text_metrics, runner and interleave equal on seeded inputs; psnr, ssim and
calc_metrics (its antialiased resize included) within 1e-5; LPIPS and the
CLIP image embedder within 1e-5; evaluate_dir over a folder with seeded
small-width CLIP and LPIPS assets, every per-image metric within 1e-4;
the CLI's JSON line with JAX's keys; the no-assets path skips as JAX's."""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rsvldm_tpu.eval as J_eval
from rsvldm_tpu.eval import interleave as J_inter
from rsvldm_tpu.eval import quality as J_quality
from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionCfg
from rsvldm_tpu.models.vlm.vision import CLIPVisionEmbedder as JEmbedder
from rsvldm_tpu.utils import convert_hf
from rsvldm_tpu.utils import metrics as J_metrics
from rsvldm_tpu.utils.lpips import LPIPS as JLPIPS
from rsvldm_tpu.utils.lpips import convert_lpips
import rsvldm_tpu_torch.eval as T_eval
from rsvldm_tpu_torch.eval import interleave as T_inter
from rsvldm_tpu_torch.eval import quality as T_quality
from rsvldm_tpu_torch.models.text.clip import CLIPTextConfig, CLIPTextTransformer
from rsvldm_tpu_torch.models.vlm.vision import (CLIPVisionConfig,
                                                CLIPVisionEmbedder)
from rsvldm_tpu_torch.utils import metrics as T_metrics
from rsvldm_tpu_torch.utils.lpips import LPIPS, VGG16Features
from rsvldm_tpu_torch.utils.tokenizer import bytes_to_unicode

torch.set_num_threads(1)

WORDS = ["river", "field", "road", "urban", "a", "the", "red", "car", "is",
         "parked", "near", "3.5", "4", "yes", "no", "b:", "A:", "(c)", "x, y",
         "it's", "option", "first", "mat", "on", "cat", "1,000", "end."]


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(0, 9))) for _ in range(n)]


# ------------------------------------------------------------ text metrics

def test_eval_exports_equal_jax():
    names = ("split_list", "get_chunk", "ChunkedEvalRunner", "rouge_l",
             "tfidf_cosine", "evaluate_captions", "normalize_answer",
             "judge_multi_choice", "evaluate_multichoice")
    for n in names:
        assert hasattr(T_eval, n) and hasattr(J_eval, n), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_metrics_equal_jax(seed):
    cands, refs = _texts(seed, 12), _texts(seed + 100, 12)
    for c, r in zip(cands, refs):
        assert T_eval.rouge_l(c, r) == J_eval.rouge_l(c, r)
        assert T_eval.rouge_l(c, r, beta=0.5) == J_eval.rouge_l(c, r, beta=0.5)
        assert T_eval.tfidf_cosine(c, r) == J_eval.tfidf_cosine(c, r)
        assert T_eval.tfidf_cosine(c, r, cands) == J_eval.tfidf_cosine(c, r, cands)
        assert T_eval.normalize_answer(c) == J_eval.normalize_answer(c)
        assert T_eval.judge_multi_choice(r, c) == J_eval.judge_multi_choice(r, c)
    pairs = list(zip(cands, refs))
    assert T_eval.evaluate_captions(pairs) == J_eval.evaluate_captions(pairs)
    samples = [{"sample_id": i, "gt_response": g, "pred_response": p}
               for i, (g, p) in enumerate(zip(refs, cands))]
    assert T_eval.evaluate_multichoice(samples) == J_eval.evaluate_multichoice(samples)


@pytest.mark.parametrize("n_items,chunks", [(10, 3), (7, 7), (3, 5), (5, 2)])
def test_runner_equals_jax(tmp_path, n_items, chunks):
    items = list(range(n_items))
    assert T_eval.split_list(items, chunks) == J_eval.split_list(items, chunks)
    for k in range(chunks + 1):
        assert T_eval.get_chunk(items, chunks, k) == J_eval.get_chunk(items, chunks, k)

    def fn(i):
        if i % 3 == 2:
            raise ValueError(f"boom {i}")
        return {"q": i, "a": i * 2}

    outs = {}
    for name, mod in (("torch", T_eval), ("jax", J_eval)):
        r = mod.ChunkedEvalRunner(items, num_chunks=chunks, chunk_idx=0)
        res = r.run(fn, tmp_path / name / "answers.jsonl")
        outs[name] = (res, (tmp_path / name / "answers.jsonl").read_text())
    assert outs["torch"] == outs["jax"]
    with pytest.raises(ValueError):
        T_eval.ChunkedEvalRunner([2]).run(fn, tmp_path / "r.jsonl", on_error="raise")


def test_interleave_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    datasets = [("Spot-the-Diff", "open-ended"), ("RAVEN", "multi-choice"),
                ("VIST", "open-ended"), ("nlrv2", "yes-no"),
                ("QBench", "multi-choice"), ("Other", "open-ended")]
    recs = []
    for i in range(40):
        ds, qt = datasets[rng.integers(len(datasets))]
        gt, pred = _texts(i, 2)
        if qt != "open-ended":
            gt = str(rng.choice(list("abcd")))
            pred = str(rng.choice(["A: x", "b", gt, "(c)", "d."]))
        recs.append({"dataset": ds, "sample_id": i, "question_type": qt,
                     "gt_response": gt, "pred_response": pred})
    assert T_inter.evaluate_results(recs) == J_inter.evaluate_results(recs)
    assert T_inter.evaluate_rouge(recs[:9]) == J_inter.evaluate_rouge(recs[:9])
    for name, mod in (("torch", T_inter), ("jax", J_inter)):
        d = tmp_path / name
        d.mkdir()
        (d / "result.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
        mod.evaluate_result_dir(str(d))
    for f in ("eval_dataset.json", "eval_dataset_details.json", "eval_cat.json"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    with pytest.raises(ValueError, match="question_type"):
        T_inter.evaluate_results([{"dataset": "Z", "question_type": "odd",
                                   "sample_id": 0, "gt_response": "",
                                   "pred_response": ""}])


# ------------------------------------------------------ PSNR, SSIM, resize

def _img(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 23, 31, 3), (1, 40, 12, 1)])
def test_psnr_ssim_equal_jax(shape):
    a = _img(1, shape)
    b = np.clip(a + 0.1 * _img(2, shape, -1, 1), 0, 1)
    for data_range in (1.0, 2.0):
        want = float(J_metrics.psnr(a, b, data_range))
        got = float(T_metrics.psnr(torch.from_numpy(a), torch.from_numpy(b), data_range))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
        want = float(J_metrics.ssim(a, b, data_range=data_range))
        got = float(T_metrics.ssim(torch.from_numpy(a), torch.from_numpy(b), data_range))
        assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("sr_side,hr_side", [(16, 32), (48, 32), (32, 32), (21, 32)])
def test_calc_metrics_equal_jax(sr_side, hr_side):
    sr = _img(3, (1, sr_side, sr_side, 3), -1, 1)
    hr = _img(4, (1, hr_side, hr_side, 3), -1, 1)
    want = J_metrics.calc_metrics(sr, hr)
    got = T_metrics.calc_metrics(torch.from_numpy(sr), torch.from_numpy(hr))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k


def test_clip_scorer_formulas_equal_jax():
    d = 8
    rng = np.random.default_rng(5)
    proj = rng.standard_normal((3, d)).astype(np.float32)
    anchors = rng.standard_normal((2, d)).astype(np.float32)

    class Tok:
        def __call__(self, texts, pad_id=0):
            return np.zeros((len(texts), 77), np.int32)

    js = J_metrics.CLIPScorer(lambda im: jnp.mean(im, axis=(1, 2)) @ proj,
                              lambda t: jnp.asarray(anchors), Tok())
    ts = T_metrics.CLIPScorer(lambda im: im.mean(dim=(1, 2)) @ torch.from_numpy(proj),
                              lambda t: torch.from_numpy(anchors), Tok())
    a, b = _img(6, (4, 5, 5, 3), -1, 1), _img(7, (4, 5, 5, 3), -1, 1)
    np.testing.assert_allclose(ts.clip_iqa(torch.from_numpy(a)).numpy(),
                               np.asarray(js.clip_iqa(jnp.asarray(a))), atol=1e-6)
    np.testing.assert_allclose(
        ts.sms(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(js.sms(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


# ---------------------------------------------------------- LPIPS and CLIP

def _seeded_lpips(seed=0):
    torch.manual_seed(seed)
    m = LPIPS()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.05)
            if p.dim() == 4 and p.shape[-1] == 3:
                p.mul_((2.0 / (9 * p.shape[1])) ** 0.5 / 0.05)
    return m.eval()


def _lpips_sds(m):
    sd = m.state_dict()
    vgg = {k: v for k, v in sd.items() if k.startswith("features.")}
    lin = {k: v for k, v in sd.items() if k.startswith("lin")}
    return vgg, lin


def test_lpips_equals_jax():
    m = _seeded_lpips()
    vgg, lin = _lpips_sds(m)
    del lin["lin2.model.1.weight"]  # an absent head: ones on both sides
    with torch.no_grad():
        m.lin2.model[1].weight.fill_(1.0)
    x, y = _img(8, (2, 32, 32, 3), -1, 1), _img(9, (2, 32, 32, 3), -1, 1)
    want = np.asarray(JLPIPS().apply(convert_lpips(vgg, lin), x, y))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        feats = VGG16Features.forward(m, torch.from_numpy(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert [f.shape[1:] for f in feats] == [(64, 32, 32), (128, 16, 16),
                                           (256, 8, 8), (512, 4, 4), (512, 2, 2)]


VISION = dict(image_size=28, patch_size=14, width=64, layers=2, heads=2)


def _seeded(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight") and ("norm" in name or "ln" in name):
                p.copy_(1.0 + 0.1 * torch.randn_like(p))
            else:
                p.copy_(0.1 * torch.randn_like(p))
    return module.eval()


def test_clip_vision_embedder_equals_jax():
    m = _seeded(CLIPVisionEmbedder(CLIPVisionConfig(**VISION), projection_dim=32), 1)
    sd = m.state_dict()
    jcfg = JVisionCfg(**VISION)
    params = convert_hf.convert_hf_clip_embedder(sd, jcfg)
    px = _img(10, (2, 28, 28, 3), -1, 1)
    want = np.asarray(JEmbedder(jcfg, projection_dim=32).apply(params, px))
    with torch.no_grad():
        got = m(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert set(sd) >= {"vision_model.post_layernorm.weight", "visual_projection.weight"}


# ------------------------------------------------- evaluate_dir end to end

def _write_assets(d, lpips=True):
    """A seeded small-width HF CLIPModel (vision 2 x 64 at 28^2, text 2 x 64,
    projection 32, JAX's fixed vocabulary of 49408) with config.json, a
    byte-level CLIP vocabulary, and LPIPS's two files."""
    from safetensors.torch import save_file

    vision = _seeded(CLIPVisionEmbedder(CLIPVisionConfig(**VISION), 32), 2)
    text = _seeded(CLIPTextTransformer(CLIPTextConfig(
        vocab_size=49408, width=64, layers=2, heads=2, use_text_projection=True,
        projection_dim=32)), 3)
    (d / "clip").mkdir(parents=True)
    sd = {**vision.state_dict(), **text.state_dict(),
          "logit_scale": torch.tensor(4.6052)}
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(d / "clip" / "model.safetensors"))
    (d / "clip" / "config.json").write_text(json.dumps(
        {"vision_config": {"num_attention_heads": 2},
         "text_config": {"num_attention_heads": 2}}))
    base = list(bytes_to_unicode().values())
    toks = base + [v + "</w>" for v in base] + ["<|startoftext|>", "<|endoftext|>"]
    (d / "clip_vocab").mkdir()
    (d / "clip_vocab" / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(toks)}))
    (d / "clip_vocab" / "merges.txt").write_text("#version: 0.2\n")
    if lpips:
        vgg, lin = _lpips_sds(_seeded_lpips(4))
        (d / "lpips").mkdir()
        torch.save(vgg, d / "lpips" / "vgg16.pth")
        torch.save(lin, d / "lpips" / "lpips_vgg.pth")
    return d


def _write_images(root):
    """SR outputs named as the folder CLI names them and their HR images:
    a pair of the same size, a pair to resize (40^2 SR against 32^2 HR),
    an identical pair, and an SR image with no HR."""
    sr_d, hr_d = root / "out", root / "hr"
    sr_d.mkdir()
    hr_d.mkdir()
    rng = np.random.default_rng(12)
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)
    hr = {n: u8(32, 32, 3) for n in ("a", "b", "c")}
    for n, img in hr.items():
        Image.fromarray(img).save(hr_d / f"{n}.png")
    Image.fromarray(u8(32, 32, 3)).save(sr_d / "a_final_0.png")
    Image.fromarray(u8(40, 40, 3)).save(sr_d / "b_final_1.png")
    Image.fromarray(hr["c"]).save(sr_d / "sr3_c.png")
    Image.fromarray(u8(32, 32, 3)).save(sr_d / "d_final_0.png")
    return sr_d, hr_d


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality")
    ckpt = _write_assets(root / "ckpt")
    sr_d, hr_d = _write_images(root)
    out = {}
    for name, mod, kw in (("jax", J_quality, {}),
                          ("torch", T_quality, {"device": "cpu"})):
        out[name] = mod.evaluate_dir(sr_d, hr_d, ckpt, **kw)
    shutil.rmtree(ckpt / "jax", ignore_errors=True)  # JAX's LPIPS cache
    return root, ckpt, sr_d, hr_d, out


@pytest.mark.parametrize("metric", ["CLIP-IQA", "SMS", "PSNR", "SSIM", "LPIPS"])
def test_evaluate_dir_equals_jax(evaluated, metric):
    *_, out = evaluated
    j, t = out["jax"], out["torch"]
    assert [r["image"] for r in t["images"]] == [r["image"] for r in j["images"]]
    assert [sorted(r) for r in t["images"]] == [sorted(r) for r in j["images"]]
    vals = [(r[metric], q[metric]) for r, q in zip(t["images"], j["images"])
            if metric in q]
    assert len(vals) == (4 if metric == "CLIP-IQA" else 3)
    for got, want in vals:
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (metric, got, want)
    assert abs(t[metric] - j[metric]) <= 1e-4 * max(1.0, abs(j[metric]))
    assert t["num_images"] == j["num_images"] == 4


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_json_line_equals_jax(evaluated, tmp_path):
    root, ckpt, sr_d, hr_d, _ = evaluated
    args = ["--sr_dir", str(sr_d), "--hr_dir", str(hr_d), "--ckpt_dir", str(ckpt)]
    j = _cli(J_quality.main, args + ["--out", str(tmp_path / "j.json")])
    t = _cli(T_quality.main, args + ["--out", str(tmp_path / "t.json"),
                                     "--device", "cpu"])
    shutil.rmtree(ckpt / "jax", ignore_errors=True)
    assert list(t) == list(j) == ["num_images", "CLIP-IQA", "SMS", "PSNR",
                                  "SSIM", "LPIPS"]
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), k
    jo, to = (json.loads((tmp_path / f).read_text()) for f in ("j.json", "t.json"))
    assert list(to) == list(jo) and len(to["images"]) == len(jo["images"])


def test_missing_assets_skip_as_jax(tmp_path):
    """No clip/ or lpips/: PSNR and SSIM alone; a clip/ without its
    tokenizer, or without the text tower: no scorer, as JAX's."""
    sr_d, hr_d = _write_images(tmp_path)
    j = J_quality.evaluate_dir(sr_d, hr_d, ckpt_dir=tmp_path)
    t = T_quality.evaluate_dir(sr_d, hr_d, ckpt_dir=tmp_path, device="cpu")
    assert list(t) == list(j) == ["num_images", "PSNR", "SSIM", "images"]
    ckpt = _write_assets(tmp_path / "ckpt", lpips=False)
    assert T_metrics.load_lpips(ckpt, "cpu") is None
    shutil.rmtree(ckpt / "clip_vocab")
    assert T_quality.build_clip_scorer(ckpt, "cpu") is None
    assert J_quality.build_clip_scorer(ckpt, jit=False) is None
    assert T_quality.build_clip_scorer(tmp_path, "cpu") is None


@pytest.mark.parametrize("stem", ["x_final_0", "x_final_12", "sr3_x", "x_final",
                                  "x_sr3", "x", "sr3_x_final_3", "a_final_b"])
def test_strip_suffixes_equal_jax(stem):
    assert T_quality._strip_suffixes(stem) == J_quality._strip_suffixes(stem)
