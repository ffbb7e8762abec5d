"""The port's finetune data path and CLI held against the JAX package: the
llama-3 dataset, the length-grouped sampler, expand2square, worker_map,
the image splice, and the smoke CLI, whose adapter archive JAX's
load_lora_npz reads."""

import json
import re
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.training import vlm_data as jdata
from rsvldm_tpu.training.vlm_trainer import load_lora_npz as jax_load_lora
from rsvldm_tpu_torch import train_vlm as ttrain
from rsvldm_tpu_torch.training import vlm_data as tdata

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SP = dict(bos=501, start_header=502, end_header=503, eot=504, nl=505)


def _records(n=11):
    recs = []
    for i in range(n):
        rec = {"id": i, "conversations": [
            {"from": "human",
             "value": ("look <image> here: " if i % 3 else "") +
                      " ".join(f"q{j}" for j in range(i % 5 + 2))},
            {"from": "gpt", "value": " ".join(f"a{i}{j}" for j in range(i + 1))},
            {"from": "human", "value": "and then"},
            {"from": "gpt", "value": "done"}]}
        if i % 3:
            rec["image"] = f"img_{i}.png"
        recs.append(rec)
    return recs


@pytest.mark.parametrize("fmt", ["json", "jsonl", "brace", "yaml"])
def test_dataset_and_sampler_equal_jax(tmp_path, fmt):
    """Same records, tokenizer and seed: the same input_ids and labels per
    item and the same length-grouped orders (modality-grouped and plain)."""
    recs = _records()
    if fmt == "json":
        path = tmp_path / "d.json"
        path.write_text(json.dumps(recs))
    elif fmt == "jsonl":
        path = tmp_path / "d.jsonl"
        path.write_text("\n".join(json.dumps(r) for r in recs))
    elif fmt == "brace":
        (tmp_path / "da.json").write_text(json.dumps(recs[:4]))
        (tmp_path / "db.json").write_text(json.dumps(recs[4:]))
        path = tmp_path / "d{a,b}.json"
    else:
        (tmp_path / "a.json").write_text(json.dumps(recs[:6]))
        (tmp_path / "b.json").write_text(json.dumps(recs[6:]))
        path = tmp_path / "d.yaml"
        path.write_text(f"datasets:\n  - json_path: {tmp_path / 'a.json'}\n"
                        f"    sampling_strategy: random:4\n"
                        f"  - json_path: {tmp_path / 'b.json'}\n"
                        f"    sampling_strategy: first:50%\n")
    jds = jdata.LazyConversationDataset(
        str(path), ttrain._hash_encode, seed=3,
        preprocess_kw={"sp": jdata.Llama3Special(**SP)})
    tds = tdata.LazyConversationDataset(
        str(path), ttrain._hash_encode, seed=3,
        preprocess_kw={"sp": tdata.Llama3Special(**SP)})
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    assert tds.lengths == jds.lengths
    assert tds.modality_lengths == jds.modality_lengths
    for seed in (0, 5):
        assert (tdata.get_modality_length_grouped_indices(
            tds.modality_lengths, 2, 1, seed)
            == jdata.get_modality_length_grouped_indices(
                jds.modality_lengths, 2, 1, seed))
        assert (tdata.get_length_grouped_indices(tds.lengths, 3, 2, seed)
                == jdata.get_length_grouped_indices(jds.lengths, 3, 2, seed))


@pytest.mark.parametrize("size", [(40, 40), (56, 30), (30, 56)])
def test_expand2square_equals_jax(size):
    from PIL import Image
    from rsvldm_tpu.models.vlm.anyres import expand2square as jax_e2s
    from rsvldm_tpu_torch.models.vlm.anyres import expand2square
    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                       dtype=np.uint8))
    np.testing.assert_array_equal(np.asarray(expand2square(img, (1, 2, 3))),
                                  np.asarray(jax_e2s(img, (1, 2, 3))))


def test_worker_map_keeps_order_and_raises():
    """Threaded map yields in submission order for any worker count, as
    JAX's worker_map; a worker's exception reaches the consumer."""
    import time
    from rsvldm_tpu.data.prefetch import worker_map as jax_worker_map
    from rsvldm_tpu_torch.data.prefetch import worker_map

    def slow_square(i):
        time.sleep(0.002 * (7 - i % 7))
        return i * i

    want = list(jax_worker_map(slow_square, range(30), num_workers=4))
    for n in (0, 1, 4):
        assert list(worker_map(slow_square, range(30), num_workers=n)) == want

    def bad(i):
        if i == 5:
            raise KeyError(i)
        return i
    with pytest.raises(KeyError):
        list(worker_map(bad, range(10), num_workers=3))


def test_unported_templates_and_video_raise(tmp_path):
    """Every template, video records, --dpo and projector tuning are
    ported and run (tests below and tests/test_torch_vlm_data.py); what
    still raises is what the JAX package refuses: an unknown template, a
    video record without its frames, --force_sample without
    --frames_upbound, --dpo with projector tuning, an unknown --tune part,
    anyres with projector tuning and a projector-tuning record without an
    image or without <image>."""
    path = tmp_path / "d.json"
    path.write_text(json.dumps([{"video": "shareVideoGPTV/none",
                                 "conversations": [
                                     {"from": "human", "value": "<image> hi"},
                                     {"from": "gpt", "value": "yes"}]}]))
    for template in ("chatml", "v1", "llama_3"):
        tdata.LazyConversationDataset(str(path), ttrain._hash_encode,
                                      template=template)
    with pytest.raises(ValueError, match="unknown conversation template"):
        tdata.preprocess([], ttrain._hash_encode, "vicuna")
    with pytest.raises(FileNotFoundError):
        tdata.LazyConversationDataset(str(path), ttrain._hash_encode,
                                      video_folder=str(tmp_path))[0]
    base = ["--data_path", "x", "--output_dir", "o"]
    for flags in (["--dpo"], ["--tune", "lora,projector"], ["--video_folder", "v"],
                  ["--template", "plain"], ["--tune", "projector"]):
        ttrain.check_args(ttrain.parse_args([*base, *flags]))
    for flags, msg in ((["--force_sample"], "frames_upbound"),
                       (["--dpo", "--tune", "projector"], "LoRA adapters only"),
                       (["--tune", "lora,vision"], "comma list")):
        with pytest.raises(SystemExit, match=msg):
            ttrain.check_args(ttrain.parse_args([*base, *flags]))
    cap = types.SimpleNamespace(
        vision=types.SimpleNamespace(cfg=types.SimpleNamespace(image_size=28)),
        image_newline=torch.zeros(4))
    with pytest.raises(SystemExit, match="anyres"):
        ttrain.captioner_features(ttrain.parse_args(
            [*base, "--image_aspect_ratio", "anyres"]), cap, ("projector",))
    embed = lambda ids: torch.zeros((len(ids), 4))
    with pytest.raises(SystemExit, match="placeholder"):
        ttrain.reserve_image_span(np.array([3, 4]), np.array([3, 4]), embed,
                                  2, -100)
    (tmp_path / "noimg.json").write_text(json.dumps([{"conversations": [
        {"from": "human", "value": "hi"}, {"from": "gpt", "value": "yo"}]}]))
    with pytest.raises(SystemExit, match="requires image records"):
        ttrain.main(["--smoke", "--device", "cpu", "--tune", "projector",
                     "--data_path", str(tmp_path / "noimg.json"),
                     "--output_dir", str(tmp_path / "o"), "--batch_size", "1"])


def test_splice_and_preprocess_conversation_equal_jax():
    sys.path.insert(0, str(REPO))
    from train_vlm import splice_training_sample as jax_splice
    from rsvldm_tpu.training.vlm_trainer import preprocess_conversation as jpc
    from rsvldm_tpu_torch.training.vlm_trainer import preprocess_conversation
    for got, want in zip(preprocess_conversation(np.array([1, 2, 3]),
                                                 np.array([10, 11]), 63),
                         jpc(np.array([1, 2, 3]), np.array([10, 11]), 63)):
        np.testing.assert_array_equal(got, want)
    ids = np.array([5, tdata.IMAGE_TOKEN_INDEX, 7, 8], np.int32)
    labels = np.array([-100, -100, 7, 8], np.int32)
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    feats = np.full((3, 4), 9.0, np.float32)
    want_e, want_l = jax_splice(ids, labels, lambda x: jnp.asarray(table[x]),
                                jnp.asarray(feats), -100)
    got_e, got_l = ttrain.splice_training_sample(
        ids, labels, lambda x: torch.from_numpy(table[x]),
        torch.from_numpy(feats), -100)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_l, want_l)


def test_cli_smoke_trains_and_jax_reads_the_archive(tmp_path):
    """python -m rsvldm_tpu_torch.train_vlm --smoke --device cpu, int8 base,
    as tests/test_train_vlm_cli.py runs the JAX CLI."""
    recs = [{"id": i, "conversations": [
        {"from": "human", "value": f"describe scene {i} in the image"},
        {"from": "gpt", "value": f"a town with {i} harbors and trees"}]}
        for i in range(6)]
    (tmp_path / "train.json").write_text(json.dumps(recs))
    out = subprocess.run(
        [sys.executable, "-m", "rsvldm_tpu_torch.train_vlm", "--smoke",
         "--device", "cpu", "--data_path", str(tmp_path / "train.json"),
         "--output_dir", str(tmp_path / "out"), "--epochs", "12",
         "--batch_size", "2", "--pad_to", "16", "--lr", "5e-2", "--bits", "8"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["steps"] == 36
    assert res["final_loss"] < res["first_loss"] * 0.8, res
    lora, cfg = jax_load_lora(res["adapters"])
    assert cfg.r == 16 and set(lora) == {"layer_0", "layer_1"}
    assert set(lora["layer_0"]) == set(cfg.targets)
    assert lora["layer_0"]["q_proj"]["a"].shape == (32, 16)
    assert float(np.abs(np.asarray(lora["layer_0"]["q_proj"]["b"])).max()) > 0


def test_cli_without_checkpoint_exits(tmp_path):
    (tmp_path / "d.json").write_text("[]")
    with pytest.raises(SystemExit, match="no checkpoint"):
        ttrain.main(["--data_path", str(tmp_path / "d.json"), "--output_dir",
                     str(tmp_path / "o"), "--ckpt_dir", str(tmp_path),
                     "--device", "cpu"])


# ------------------------------------------- the recipes against JAX's CLI
def _recipe_data(tmp_path: Path, recipe: str) -> list:
    """Records of a recipe, written to tmp_path/train.json; returns the
    recipe's flags."""
    if recipe == "dpo":
        recs = [{"id": i, "prompt": f"describe tile {i} of the harbor",
                 "chosen": " ".join(f"good{j}" for j in range(3 + i)),
                 "rejected": " ".join(f"bad{j}" for j in range(5 - i % 3))}
                for i in range(6)]
        flags = ["--dpo", "--dpo_beta", "0.2"]
    elif recipe == "video":
        from PIL import Image
        rng = np.random.default_rng(0)
        for v in range(2):
            d = tmp_path / "vids" / "shareVideoGPTV" / f"v{v}"
            d.mkdir(parents=True)
            for i in range(3 + v):
                Image.fromarray((rng.random((8, 8, 3)) * 255).astype(
                    np.uint8)).save(d / f"{i}.png")
        recs = [{"id": i, "video": f"shareVideoGPTV/v{i % 2}",
                 "conversations": [
                     {"from": "human", "value": f"<image> what moves {i}"},
                     {"from": "gpt", "value": " ".join(
                         f"m{i}{j}" for j in range(i + 2))}]}
                for i in range(4)]
        flags = ["--video_folder", str(tmp_path / "vids")]
    else:
        recs = [{"id": i, "image": f"tile_{i}.png", "conversations": [
            {"from": "human", "value": f"<image>\ndescribe scene {i}"},
            {"from": "gpt", "value": f"a town with {i} harbors and trees"}]}
            for i in range(6)]
        flags = ["--tune", recipe]
        if recipe == "lora,projector":
            flags += ["--mm_projector_lr", "3e-3"]
    (tmp_path / "train.json").write_text(json.dumps(recs))
    return flags


@pytest.mark.parametrize("recipe", ["projector", "lora,projector", "dpo",
                                    "video", "lora"])
def test_cli_smoke_recipes_equal_jax_cli(tmp_path, monkeypatch, capsys,
                                         recipe):
    """The root train_vlm.py --smoke (its defaults: int8 base, lr 2e-4; 3
    steps) and the port's train() on the same smoke decoder (JAX's
    PRNGKey(0) init through params_from_jax, the embedding kept fp32 as
    JAX's smoke quantization keeps it), JAX's initial adapters, projector
    (PRNGKey(7)) and stand-in features (PRNGKey(11) / PRNGKey(13)) fed in:
    the printed first and final losses within 1e-5, and the archives each
    wrote within 1e-4. (At lr 1e-2 the int8 lora,projector run's third
    loss parts from JAX's by 1.5e-4: Adam turns fp32 rounding of the
    smallest gradients into whole steps, and the int8 activation rounding
    flips on them; the trainers' lr 1e-2 parity on fp, int8 and int4 bases
    is held in tests/test_torch_mm_dpo.py.)"""
    import jax
    import jax.numpy as jnp
    from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
    from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
    from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
    from rsvldm_tpu.models.vlm.llama import quantize_llama_params
    from rsvldm_tpu.models.vlm.projector import MLPProjector as JProjector
    from rsvldm_tpu.training import vlm_trainer as jt
    from rsvldm_tpu_torch.models.vlm.captioner import LlavaCaptioner
    from rsvldm_tpu_torch.models.vlm.llama import quantize_llama_
    from rsvldm_tpu_torch.models.vlm.projector import MLPProjector
    from rsvldm_tpu_torch.training.vlm_trainer import load_lora_npz
    from rsvldm_tpu_torch.utils.weights import lora_from_jax, params_from_jax
    sys.path.insert(0, str(REPO))
    import train_vlm as jcli
    monkeypatch.setenv("RSVLDM_COMPILE_CACHE", "0")
    flags = _recipe_data(tmp_path, recipe)
    common = ["--smoke", "--data_path", str(tmp_path / "train.json"),
              "--epochs", "3", "--steps", "3", "--batch_size", "2",
              "--pad_to", "64", "--bits", "8",
              "--num_workers", "0", "--seed", "1", *flags]
    jcli.main([*common, "--output_dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX smoke model, adapters, projector and stand-in features
    jcfg = JLlamaConfig(vocab_size=512, dim=32, layers=2, heads=4, kv_heads=2,
                        ffn_dim=64, dtype=jnp.float32)
    jm = JLlama(jcfg)
    jparams = jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(jcfg, 1, 8), 0,
        method=jm.from_tokens))(jax.random.PRNGKey(0))
    qparams = {"params": quantize_llama_params(jparams["params"], mode="int8")}
    cap = LlavaCaptioner.seeded(ttrain.SMOKE_LLAMA, ttrain.SMOKE_VISION,
                                ttrain.HashTokenizer(), device="cpu")
    cap.llama.load_state_dict(params_from_jax("llama", jparams,
                                              ttrain.SMOKE_LLAMA))
    quantize_llama_(cap.llama, "int8", embed_dtype=torch.float32)
    tune = tuple(recipe.split(",")) if recipe not in ("dpo", "video") \
        else ("lora",)
    lora = (lora_from_jax(jax.tree_util.tree_map(np.asarray, jt.init_lora(
        qparams, jt.LoraConfig(), jax.random.PRNGKey(1))))
        if "lora" in tune else None)
    feats = ttrain.Features(video=lambda frames: torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(13), (len(frames) * 4, 32)))))
    if "projector" in tune:
        jp = JProjector(out_dim=32, dtype=jnp.float32)
        ptree = jp.init(jax.random.PRNGKey(7), jnp.zeros((1, 4, 8)))
        cap.projector = MLPProjector(8, 32)
        cap.projector.load_state_dict(params_from_jax(
            "projector", jax.tree_util.tree_map(np.asarray, ptree), None))
        vis = torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.PRNGKey(11), (4, 8))))
        feats = ttrain.Features(process_image=lambda path: path,
                                image_raw=lambda _: vis, img_tokens=4)
    args = ttrain.parse_args([*common, "--output_dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    got, _ = ttrain.train(args, cap, encode=ttrain._hash_encode,
                          preprocess_kw={"sp": ttrain.SMOKE_SPECIAL},
                          features=feats, lora=lora)
    printed = capsys.readouterr().out
    assert re.findall(r"step (\d+) epoch", printed) == ["1"]
    assert got["steps"] == want["steps"] == 3
    for k in ("first_loss", "final_loss"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert ("adapters" in got) == ("adapters" in want) == ("lora" in tune)
    if "lora" in tune:
        gl, gcfg = load_lora_npz(got["adapters"])
        wl, wcfg = load_lora_npz(want["adapters"])
        assert gcfg == wcfg
        for p, ab in wl.items():
            for n in ("a", "b"):
                np.testing.assert_allclose(gl[p][n].numpy(), ab[n].numpy(),
                                           atol=1e-4, rtol=0)
    if "projector" in tune:
        gp = np.load(got["projector"])
        wp = np.load(want["projector"])
        assert sorted(gp.files) == sorted(wp.files)
        for k in wp.files:
            np.testing.assert_allclose(gp[k], wp[k], atol=1e-4, rtol=0)


@pytest.mark.parametrize("flags", [
    ["--template", "chatml"], ["--template", "v1"], ["--template", "plain"],
    ["--tune", "projector", "--bits", "4"], ["--dpo", "--bits", "16"],
    ["--video_folder", "VIDS", "--mm_newline_position", "frame"]])
def test_cli_smoke_runs_every_recipe(tmp_path, flags):
    """python -m rsvldm_tpu_torch.train_vlm --smoke --device cpu takes every
    template and recipe: it prints its result and writes its archives."""
    if "--dpo" in flags:
        _recipe_data(tmp_path, "dpo")
    elif "--video_folder" in flags:
        _recipe_data(tmp_path, "video")
        flags = [f.replace("VIDS", str(tmp_path / "vids")) for f in flags]
    else:
        _recipe_data(tmp_path, "projector")
        if "plain" in flags:  # the plain template: <image> then the caption
            recs = json.loads((tmp_path / "train.json").read_text())
            for r in recs:
                r["conversations"][0]["value"] = "<image>"
            (tmp_path / "train.json").write_text(json.dumps(recs))
    ttrain.main(["--smoke", "--device", "cpu", "--data_path",
                 str(tmp_path / "train.json"), "--output_dir",
                 str(tmp_path / "out"), "--steps", "2", "--batch_size", "2",
                 "--pad_to", "16", "--num_workers", "0", *flags])
    out = tmp_path / "out"
    assert (out / "projector_final.npz").exists() == ("projector" in flags)
    assert (out / "lora_final.npz").exists() == ("projector" not in flags)
