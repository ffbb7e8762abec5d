"""The port's finetune data held against the JAX package: the chatml, v1
and plain templates, the preference dataset, the collator and the epoch
iterator (ids, labels and arrays exactly equal); video records (frame
folders, a container through OpenCV, the time instruction), the pooled
video feature stream for every pool mode and newline position, and the
captioner's video_features end to end."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.models.vlm import video as jvideo
from rsvldm_tpu.training import vlm_data as jdata
from rsvldm_tpu_torch import train_vlm as ttrain
from rsvldm_tpu_torch.models.vlm import video as tvideo
from rsvldm_tpu_torch.training import vlm_data as tdata

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
enc = ttrain._hash_encode


def _convs():
    """Conversations with and without <image>, an odd trailing human turn,
    role/content keys and a leading system turn."""
    return [
        [{"from": "human", "value": "<image>\nwhat is here"},
         {"from": "gpt", "value": "a harbor with ships"}],
        [{"from": "system", "value": "be brief"},
         {"from": "human", "value": "count the roofs"},
         {"from": "gpt", "value": "twelve red roofs"},
         {"from": "human", "value": "and trees?"},
         {"from": "gpt", "value": "none at all"}],
        [{"role": "user", "content": "where <image> is the road"},
         {"role": "assistant", "content": "to the north"},
         {"role": "user", "content": "anything else"}],
    ]


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


@pytest.mark.parametrize("template,kw", [
    ("chatml", {"sp": "chatml"}), ("qwen", {}), ("v1", {}),
    ("v1", {"boundary_compat": True, "system": "sys prompt"}),
    ("llama_v3", {"sp": "llama3"})])
def test_templates_equal_jax(template, kw):
    def specials(pkg):
        if kw.get("sp") == "chatml":
            return {"sp": pkg.ChatMLSpecial(im_start=506, im_end=507, nl=508)}
        if kw.get("sp") == "llama3":
            return {"sp": pkg.Llama3Special(bos=501, start_header=502,
                                            end_header=503, eot=504, nl=505)}
        return {k: v for k, v in kw.items() if k != "sp"}
    for conv in _convs():
        conv = tdata.normalize_multimodal(conv)
        assert conv == jdata.normalize_multimodal(conv)
        _equal(tdata.preprocess(conv, enc, template, **specials(tdata)),
               jdata.preprocess(conv, enc, template, **specials(jdata)))


@pytest.mark.parametrize("bos", [None, 1])
def test_plain_template_equal_jax(bos):
    conv = [{"from": "human", "value": "<image>"},
            {"from": "gpt", "value": "an airport seen from above"}]
    got = tdata.preprocess(conv, enc, "plain", bos=bos)
    _equal(got, jdata.preprocess(conv, enc, "plain", bos=bos))
    assert (got[1] != tdata.IGNORE_INDEX).sum() == len(enc(
        "an airport seen from above\n"))
    with pytest.raises(ValueError, match="unknown conversation template"):
        tdata.preprocess(conv, enc, "vicuna")
    with pytest.raises(ValueError, match="<image>"):
        tdata.preprocess([conv[1], conv[1]], enc, "plain")


def _pref_records(n=7):
    return [{"id": i, "prompt": f"describe tile {i} <image>" if i % 2 else
             f"describe tile {i}",
             "chosen": " ".join(f"c{i}{j}" for j in range(i + 2)),
             "rejected": " ".join(f"r{i}{j}" for j in range(7 - i)),
             **({"image": f"t{i}.png"} if i % 2 else {})} for i in range(n)]


def test_preference_dataset_equal_jax(tmp_path):
    path = tmp_path / "pref.json"
    path.write_text(json.dumps(_pref_records()))
    kw = dict(preprocess_kw={"sp": None}, process_image=lambda p: p)
    sp = dict(bos=501, start_header=502, end_header=503, eot=504, nl=505)
    jds = jdata.LazyPreferenceDataset(
        str(path), enc, **{**kw, "preprocess_kw": {"sp": jdata.Llama3Special(**sp)}})
    tds = tdata.LazyPreferenceDataset(
        str(path), enc, **{**kw, "preprocess_kw": {"sp": tdata.Llama3Special(**sp)}})
    assert tds.lengths == jds.lengths
    assert tds.modality_lengths == jds.modality_lengths
    for i in range(len(jds)):
        got, want = tds[i], jds[i]
        assert set(got) == set(want)
        for k in want:
            if k.endswith(("_input_ids", "_labels")):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k]


def _sft_records(n=9):
    return [{"id": i, "conversations": [
        {"from": "human", "value": ("look <image> " if i % 3 else "")
         + " ".join(f"q{j}" for j in range(i % 4 + 1))},
        {"from": "gpt", "value": " ".join(f"a{i}{j}" for j in range(i + 2))}],
        **({"image": f"im{i}.png"} if i % 3 else {})} for i in range(n)]


@pytest.mark.parametrize("max_length,multiple,side", [
    (None, 64, "right"), (9, 8, "right"), (None, 0, "left"), (12, 16, "left")])
def test_collate_equal_jax(tmp_path, max_length, multiple, side):
    path = tmp_path / "d.json"
    path.write_text(json.dumps(_sft_records()))
    sp = dict(bos=501, start_header=502, end_header=503, eot=504, nl=505)
    tds = tdata.LazyConversationDataset(
        str(path), enc, process_image=lambda p: p,
        preprocess_kw={"sp": tdata.Llama3Special(**sp)})
    jds = jdata.LazyConversationDataset(
        str(path), enc, process_image=lambda p: p,
        preprocess_kw={"sp": jdata.Llama3Special(**sp)})
    items = [tds[i] for i in (0, 1, 4, 6)]
    got = tdata.collate(items, pad_id=3, max_length=max_length,
                        pad_to_multiple=multiple, padding_side=side)
    want = jdata.collate([jds[i] for i in (0, 1, 4, 6)], pad_id=3,
                         max_length=max_length, pad_to_multiple=multiple,
                         padding_side=side)
    assert set(got) == set(want)
    for k in ("input_ids", "labels", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert got["images"] == want["images"]


@pytest.mark.parametrize("grouped", [True, False])
def test_iter_batches_equal_jax(tmp_path, grouped):
    path = tmp_path / "d.json"
    path.write_text(json.dumps(_sft_records(11)))
    sp = dict(bos=501, start_header=502, end_header=503, eot=504, nl=505)
    tds = tdata.LazyConversationDataset(
        str(path), enc, preprocess_kw={"sp": tdata.Llama3Special(**sp)})
    jds = jdata.LazyConversationDataset(
        str(path), enc, preprocess_kw={"sp": jdata.Llama3Special(**sp)})
    kw = dict(batch_size=3, world_size=1, seed=4, max_length=20,
              pad_to_multiple=8, group_by_modality_length=grouped)
    got = list(tdata.iter_batches(tds, **kw))
    want = list(jdata.iter_batches(jds, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("input_ids", "labels", "attention_mask"):
            np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------------------- video
def _frame_folder(root: Path, name: str, n: int, seed: int) -> Path:
    d = root / "shareVideoGPTV" / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random((30, 44, 3)) * 255).astype(np.uint8)).save(
            d / f"f{i:03d}.png")
    return d


@pytest.mark.parametrize("n,want_n", [(23, 10), (4, 4)])
def test_frame_folder_sampling_and_time_instruction_equal(tmp_path, n, want_n):
    d = _frame_folder(tmp_path, "v", n, n)
    frames, vt, ft = tvideo.sample_video_frames(str(d), 10)
    jframes, jvt, jft = jvideo.sample_video_frames(str(d), 10)
    assert (vt, ft) == (jvt, jft) and len(frames) == len(jframes) == want_n
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (tvideo.time_instruction(vt, len(frames), ft)
            == jvideo.time_instruction(jvt, len(jframes), jft))
    np.testing.assert_array_equal(tvideo.clip_preprocess_frame(frames[0], 28),
                                  jvideo.clip_preprocess_frame(jframes[0], 28))


def test_container_video_equal_jax(tmp_path):
    """process_video on OpenCV: the same frames, times and counts, sparse
    (seeking) and dense (decoding in order) sampling."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_video import _write_video
    path = _write_video(tmp_path / "clip.mp4", n_frames=40, fps=6)
    for kw in (dict(video_fps=1), dict(video_fps=6, frames_upbound=3),
               dict(video_fps=1, frames_upbound=4, force_sample=True)):
        got = tvideo.process_video(str(path), **kw)
        want = jvideo.process_video(str(path), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    with pytest.raises(FileNotFoundError):
        tvideo.process_video(str(tmp_path / "missing.mp4"))


@pytest.mark.parametrize("time_instr,force", [(False, False), (True, True)])
def test_video_records_equal_jax(tmp_path, time_instr, force):
    """Frame-folder and container records through the dataset: the same
    ids, labels and frames; the time instruction in the first turn."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_video import _write_video
    _frame_folder(tmp_path, "a", 14, 1)
    _write_video(tmp_path / "b.mp4", n_frames=18, fps=6)
    recs = [{"id": 0, "video": "shareVideoGPTV/a", "conversations": [
        {"from": "human", "value": "what happens <image>"},
        {"from": "gpt", "value": "boats move east"}]},
        {"id": 1, "video": "b.mp4", "conversations": [
            {"from": "human", "value": "<image> describe"},
            {"from": "gpt", "value": "a red screen"}]}]
    path = tmp_path / "v.json"
    path.write_text(json.dumps(recs))
    sp = dict(bos=501, start_header=502, end_header=503, eot=504, nl=505)
    kw = dict(video_folder=str(tmp_path), frames_upbound=5 if force else 0,
              force_sample=force, add_time_instruction=time_instr)
    tds = tdata.LazyConversationDataset(
        str(path), enc, preprocess_kw={"sp": tdata.Llama3Special(**sp)}, **kw)
    jds = jdata.LazyConversationDataset(
        str(path), enc, preprocess_kw={"sp": jdata.Llama3Special(**sp)}, **kw)
    assert tds.modality_lengths == jds.modality_lengths
    for i in range(2):
        got, want = tds[i], jds[i]
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert len(got["video"]) == len(want["video"])
        for a, b in zip(got["video"], want["video"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(tds[0]["video"]) == (5 if force else 10)


@pytest.mark.parametrize("position", ["grid", "frame", "one_token",
                                      "no_token"])
@pytest.mark.parametrize("mode,stride", [("average", 2), ("max", 2),
                                         ("bilinear", 2), ("bilinear", 3),
                                         ("average", 1)])
def test_video_feature_stream_equal_jax(mode, stride, position):
    """[T, h*h, D] projected frame features through the pooling and the
    newline placement: average / max exactly, bilinear within 1e-6 (the
    same fp32 interpolation tables)."""
    rng = np.random.default_rng(stride)
    feats = rng.standard_normal((3, 25, 6)).astype(np.float32)
    newline = rng.standard_normal(6).astype(np.float32)
    got = tvideo.video_feature_stream(torch.from_numpy(feats),
                                      torch.from_numpy(newline), stride,
                                      mode, position)
    want = jvideo.video_feature_stream(jnp.asarray(feats), jnp.asarray(newline),
                                       stride, mode, position)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tvideo.pool_2d(torch.zeros((1, 24, 2)), 2, mode)


def test_video_features_equal_jax(tmp_path):
    """LlavaCaptioner.video_features from one tiny HF-named LLaVA state
    dict (tests/test_captioner.py's), read by the JAX loader from
    safetensors and by from_state_dict: CLIP's frame transform, the batched
    tower and projector, the pooled stream. fp32, atol 1e-4."""
    from safetensors.torch import save_file
    from rsvldm_tpu.models.vlm.captioner import LlavaCaptioner as JCaptioner
    from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
    from rsvldm_tpu.models.vlm.vision import CLIPVisionConfig as JVisionConfig
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
    from rsvldm_tpu_torch.models.vlm.vision import CLIPVisionConfig
    sys.path.insert(0, str(REPO / "tests"))
    import test_captioner
    sd = test_captioner._tiny_llava_state_dict()
    (tmp_path / "llava").mkdir()
    save_file(sd, str(tmp_path / "llava" / "model.safetensors"))
    lk = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2,
              ffn_dim=64)
    vk = dict(image_size=28, patch_size=14, width=24, layers=2, heads=2,
              select_layer=-2)
    jcap = JCaptioner.load(tmp_path, llama_cfg=JLlamaConfig(**lk),
                           vision_cfg=JVisionConfig(**vk),
                           tokenizer=ttrain.HashTokenizer())
    tcap = LlavaCaptioner.from_state_dict(sd, LlamaConfig(**lk),
                                          CLIPVisionConfig(**vk),
                                          ttrain.HashTokenizer(), device="cpu")
    rng = np.random.default_rng(2)
    frames = [Image.fromarray((rng.random((40, 56, 3)) * 255).astype(np.uint8))
              for _ in range(3)]
    for kw in (dict(), dict(stride=1, newline_position="frame"),
               dict(pool_mode="average", newline_position="one_token")):
        with torch.no_grad():
            got = tcap.video_features(frames, **kw)
        want = jcap.video_features(frames, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
