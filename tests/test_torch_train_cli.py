"""The port's finetune data path and CLI held against the JAX package: the
llama-3 dataset, the length-grouped sampler, expand2square, worker_map,
the image splice, and the smoke CLI, whose adapter archive JAX's
load_lora_npz reads."""

import json
import subprocess
import sys
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
    path = tmp_path / "d.json"
    path.write_text(json.dumps([{"video": "v.mp4", "conversations": []}]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdata.LazyConversationDataset(str(path), ttrain._hash_encode,
                                      template="chatml")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdata.LazyConversationDataset(str(path), ttrain._hash_encode)[0]
    for flags in (["--dpo"], ["--tune", "projector"], ["--video_folder", "v"],
                  ["--template", "plain"]):
        args = ttrain.parse_args(["--data_path", "x", "--output_dir", "o",
                                  *flags])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.refuse_unported(args)


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
