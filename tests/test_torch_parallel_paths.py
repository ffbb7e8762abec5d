"""The port's data-parallel paths on 2 gloo ranks of the CPU
(tests/torch_parallel_lib.py, one launch for the file), tiny geometry:

- folder Stage 1 (`run_stage1_batch(mesh=)`, DDIM in 4 steps) at data=2
  equals the run without a mesh, uint8 for uint8: three 4^2 tiles (one
  group split 2 + 1) and one 5^2 tile (a group of one: the second rank
  runs no rows), the "stage1" draws made for the whole group and sliced;
- 3 data-parallel SR3Trainer steps at 2 ranks x 2 rows match one process
  on the global batch of 4 (JAX tests/test_distributed.py::
  test_two_process_sr3_train_matches_single): losses within 1e-5
  relative, parameters within 1e-3 of the distance they moved, and equal
  on both ranks bit for bit;
- the SR3 CLI's run (train_sr3.build_trainer + run) at 2 ranks, each
  loading only its rows of every global batch (make_loader(rows=)),
  matches its single-process run: losses within 1e-5 relative, the first
  rank alone writing the checkpoint; make_loader's rows of the ranks make
  up its global batches;
- 3 data-parallel steps of VLMTrainer and MMTrainer (LoRA and the fp32
  projector) on an int8 base and of DPOTrainer on the fp32 base (on the
  int8 base one token's activation rounding flips between the packages
  at one of the steps of this data: 1.25e-5 on that loss, 1e-7 on the
  next) at 2 ranks x 2 rows, whose rows
  hold unequal numbers of supervised tokens (18 and 4), equal one process
  on the global batch of 4 and JAX's trainers without a mesh on it
  (rsvldm_tpu/training/vlm_trainer.py): losses atol 1e-5, trainable
  leaves atol 1e-4 (tests/test_torch_training.py's limits), the ranks'
  leaves equal bit for bit, and a rank that starts from other adapters
  and another projector ends on the first rank's; DPOTrainer with the
  pairs split 3 / 1 over the ranks equals JAX the same way;
- a mesh of one rank (a world of one joined through init_distributed) is
  bit-identical to no mesh for Stage 1 and the trainers;
- ImageBatchProcessor whose batched Stage 1 fails raises on every rank
  of a mesh of 2, and falls back to per-image work without a mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rsvldm_tpu.models.vlm.llama import KVCache as JKVCache
from rsvldm_tpu.models.vlm.llama import LlamaConfig as JLlamaConfig
from rsvldm_tpu.models.vlm.llama import LlamaModel as JLlama
from rsvldm_tpu.models.vlm.llama import quantize_llama_params
from rsvldm_tpu.models.vlm.projector import MLPProjector as JProjector
from rsvldm_tpu.training import vlm_trainer as jt
from rsvldm_tpu_torch.models.vlm.llama import LlamaConfig
from rsvldm_tpu_torch.utils.weights import (lora_from_jax, lora_to_jax,
                                            params_from_jax)
from torch_parallel_lib import launch
from torch_parity_lib import randomize, to_np

RANKS = 2
SIDES = (4, 4, 5, 4)
# the data-parallel VLM trainers: a tiny decoder on an int8 base
_L = dict(vocab_size=64, dim=32, layers=2, heads=2, kv_heads=1, ffn_dim=64)
LCFG = jt.LoraConfig(r=4, alpha=16)
GB, S, T, DV = 4, 12, 3, 8  # global batch, tokens, image rows, tower width
POS = np.array([2, 3, 5, 6])
LR, PROJ_LR = 1e-2, 3e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, vlm_jax):
    work = tmp_path_factory.mktemp("paths")
    (work / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i, s in enumerate(SIDES):
        Image.fromarray((rng.random((s, s, 3)) * 255).astype(np.uint8)).save(
            work / "lr" / f"tile_{i}.png")
    _write_lrhr(work / "data", rng)
    torch.save(vlm_jax["inputs"], work / "vlm.pt")
    return launch("paths", RANKS, work), work


def _unequal_labels(rng, n_sup):
    """[GB, S] labels whose row b supervises its last n_sup[b] targets."""
    labels = rng.integers(0, 64, (GB, S)).astype(np.int32)
    for b, n in enumerate(n_sup):
        labels[b, :S - n] = jt.IGNORE_INDEX
    return labels


@pytest.fixture(scope="module")
def vlm_jax():
    """The data-parallel trainers' inputs (the port's weights, adapters,
    projector and global batches, saved for the ranks) and JAX's three
    steps of each trainer without a mesh on the global batch."""
    jcfg = JLlamaConfig(**_L)
    jm = JLlama(jcfg)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4), jnp.int32), JKVCache.init(jcfg, 1, 8), 0,
        method=jm.from_tokens), jax.random.PRNGKey(0))
    tree = to_np(randomize(shapes, 61))
    jq = JLlama(dataclasses.replace(jcfg, quant="int8"))
    jp = {"params": quantize_llama_params(tree["params"], mode="int8")}
    jproj = JProjector(out_dim=_L["dim"])
    proj_tree = to_np(randomize(jax.eval_shape(
        jproj.init, jax.random.PRNGKey(0), jnp.zeros((1, T, DV))), 62))
    rng = np.random.default_rng(63)
    emb = lambda: (rng.standard_normal((GB, S, _L["dim"])) * 0.5).astype(
        np.float32)
    # rows 0-1 (rank 0) supervise 9 targets each, rows 2-3 (rank 1) 2
    vlm = (emb(), _unequal_labels(rng, (9, 9, 2, 2)))
    dpo = (emb(), _unequal_labels(rng, (7, 6, 2, 3)), emb(),
           _unequal_labels(rng, (8, 5, 3, 2)))
    vis = rng.standard_normal((GB, T, DV)).astype(np.float32)
    mm_emb = emb()
    mm_labels = _unequal_labels(rng, (8, 7, 3, 2))
    for b, p in enumerate(POS):
        mm_emb[b, p:p + T] = 0
        mm_labels[b, :p + T] = jt.IGNORE_INDEX
    cache = JKVCache.init(dataclasses.replace(jcfg, quant="int8"), GB, S)
    fp_cache = JKVCache.init(jcfg, GB, S)
    trainers = {
        "vlm": jt.VLMTrainer(jq, jp, LCFG, lr=LR, rng=jax.random.PRNGKey(1)),
        "dpo": jt.DPOTrainer(jm, tree, LCFG, lr=LR, rng=jax.random.PRNGKey(2)),
        "mm": jt.MMTrainer(jq, jp, jproj, proj_tree, LCFG,
                           tune=("lora", "projector"), lr=LR,
                           mm_projector_lr=PROJ_LR,
                           rng=jax.random.PRNGKey(3))}
    t = lambda x: torch.from_numpy(np.asarray(x))
    inputs = dict(
        cfg=_L, sd=params_from_jax("llama", tree, LlamaConfig(**_L)),
        lora={k: lora_from_jax(to_np(tr.lora)) for k, tr in trainers.items()},
        lora_cfg=dict(r=LCFG.r, alpha=LCFG.alpha), lr=LR, proj_lr=PROJ_LR,
        proj=params_from_jax("projector", proj_tree, None),
        proj_dims=(DV, _L["dim"]),
        vlm=tuple(map(t, vlm)), dpo=tuple(map(t, dpo)),
        mm=(t(vis), t(mm_emb), t(POS), t(mm_labels)))
    steps = {
        "vlm": lambda: trainers["vlm"].train_step(
            *map(jnp.asarray, vlm), cache),
        "dpo": lambda: trainers["dpo"].train_step(
            *map(jnp.asarray, dpo), fp_cache),
        "mm": lambda: trainers["mm"].train_step(
            jnp.asarray(vis), jnp.asarray(mm_emb), POS,
            jnp.asarray(mm_labels), cache)}
    want = {k: [step() for _ in range(3)] for k, step in steps.items()}
    return dict(inputs=inputs, losses=want,
                lora={k: to_np(tr.lora) for k, tr in trainers.items()},
                proj=params_from_jax("projector",
                                     to_np(trainers["mm"].proj_params), None))


def _write_lrhr(root, rng, n: int = 10):
    """n LRHR triplets at 4 -> 16 pixels, the layout LRHRDataset reads."""
    for sub in ("hr_16", "sr_4_16", "lr_4"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        hr = Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8))
        lr = hr.resize((4, 4), Image.BICUBIC)
        hr.save(root / "hr_16" / f"{i:03d}.png")
        lr.save(root / "lr_4" / f"{i:03d}.png")
        lr.resize((16, 16), Image.BICUBIC).save(root / "sr_4_16" / f"{i:03d}.png")


def test_stage1_batch_data2_equals_no_mesh(ranks):
    ranks, _ = ranks
    for res in ranks:
        assert len(res["stage1_mesh"]) == len(res["stage1_none"]) == len(SIDES)
        for got, want, side in zip(res["stage1_mesh"], res["stage1_none"], SIDES):
            assert got.shape == (4 * side, 4 * side, 3)
            np.testing.assert_array_equal(got, want)


def test_stage1_ranks_agree(ranks):
    ranks, _ = ranks
    for a, b in zip(ranks[0]["stage1_mesh"], ranks[1]["stage1_mesh"]):
        np.testing.assert_array_equal(a, b)


def test_dp_sr3_steps_match_single_process(ranks):
    ranks, _ = ranks
    for res in ranks:
        (dp_loss, dp_p, dp_p0), (loss, p, p0) = res["train_mesh"], res["train_none"]
        assert torch.equal(dp_p0, p0)  # rank 0's state, broadcast
        np.testing.assert_allclose(dp_loss, loss, rtol=1e-5)
        moved = float((p - p0).norm())
        assert moved > 0
        assert float((dp_p - p).norm()) <= 1e-3 * moved


def test_dp_sr3_ranks_bit_equal(ranks):
    ranks, _ = ranks
    assert torch.equal(ranks[0]["train_mesh"][1], ranks[1]["train_mesh"][1])


def test_mesh_of_one_stage1_bit_identical(ranks):
    ranks, _ = ranks
    for got, want in zip(ranks[0]["one_stage1"], ranks[0]["stage1_none"],
                         strict=True):
        np.testing.assert_array_equal(got, want)


def test_mesh_of_one_sr3_bit_identical(ranks):
    ranks, _ = ranks
    (loss1, p1, _), (loss, p, _) = ranks[0]["one_train"], ranks[0]["train_none"]
    assert loss1 == loss
    assert torch.equal(p1, p)


def test_folder_failure_raises_under_a_mesh(ranks):
    """A batched stage that fails under a mesh of 2 raises on the rank (a
    per-rank fallback would unmatch the ranks' collectives); without a
    mesh the per-image fallback still runs."""
    ranks, _ = ranks
    assert [r["folder_raises_sharded"] for r in ranks] == [True, True]
    alone = ranks[0]["folder_fallback_alone"]
    assert alone["fallbacks"] == ["stage1"]
    assert [s for _, s in alone["statuses"]] == ["stage1"] * len(SIDES)


def test_cli_dp_run_matches_single_process(ranks):
    ranks, work = ranks
    want = ranks[0]["cli_single_losses"]
    assert len(want) == 3
    for res in ranks:
        np.testing.assert_allclose(res["cli_dp_losses"], want, rtol=1e-5)
    # the first rank alone saved, at the last step
    assert sorted(p.name for p in (work / "ck_dp").iterdir()) == [
        "I3_gen.pth", "I3_opt.pth"]
    dp = torch.load(work / "ck_dp" / "I3_gen.pth")
    one = torch.load(work / "ck_single" / "I3_gen.pth")
    for k, v in one.items():
        np.testing.assert_allclose(dp[k].numpy(), v.numpy(), atol=1e-5)


def test_make_loader_rows_make_up_the_global_batches(tmp_path):
    from rsvldm_tpu_torch.data.prefetch import make_loader

    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return (np.full((2,), i, np.float32),)

    def take(rows, n=4):
        it = make_loader(Items(), 4, num_workers=0, prefetch=1, device="cpu",
                         seed=3, rows=rows)
        try:
            return [next(it)[0][:, 0].tolist() for _ in range(n)]
        finally:
            it.close()

    whole, lo, hi = take(None), take((0, 2)), take((2, 4))
    for w, a, b in zip(whole, lo, hi):
        assert a + b == w
    with pytest.raises(ValueError, match="drop_last"):
        make_loader(Items(), 4, num_workers=0, device="cpu", rows=(0, 2),
                    drop_last=False)


def _leaves_close(got: dict, want_tree: dict, atol: float):
    got = lora_to_jax(got)
    assert got.keys() == want_tree.keys()
    for layer, projs in want_tree.items():
        for proj, ab in projs.items():
            for n in ("a", "b"):
                np.testing.assert_allclose(got[layer][proj][n], ab[n],
                                           atol=atol, rtol=1e-5)


@pytest.mark.parametrize("trainer", ["vlm", "dpo", "mm"])
def test_dp_vlm_trainers_equal_jax_and_one_process(ranks, vlm_jax, trainer):
    """Each rank's losses and trainable leaves after 3 data-parallel steps
    against JAX's trainer without a mesh on the global batch and the
    port's one process on it. The rows' supervised counts differ between
    the ranks (vlm: 18 against 4 targets), so a rank that divided by its
    own count, or a mean of the ranks' means, would miss."""
    ranks, _ = ranks
    want_losses = vlm_jax["losses"][trainer]
    for res in ranks:
        losses, lora, proj = res["vlm_mesh"][trainer]
        one_losses, one_lora, one_proj = res["vlm_none"][trainer]
        np.testing.assert_allclose(losses, want_losses, atol=1e-5)
        np.testing.assert_allclose(one_losses, want_losses, atol=1e-5)
        np.testing.assert_allclose(losses, one_losses, atol=1e-5)
        _leaves_close(lora, vlm_jax["lora"][trainer], 1e-4)
        _leaves_close(lora, lora_to_jax(one_lora), 1e-4)
        if trainer == "mm":
            for k, v in vlm_jax["proj"].items():
                np.testing.assert_allclose(proj[k].numpy(), v.numpy(),
                                           atol=1e-4, rtol=1e-5)
                np.testing.assert_allclose(proj[k].numpy(),
                                           one_proj[k].numpy(), atol=1e-4,
                                           rtol=1e-5)


def test_dp_dpo_uneven_pairs_equal_jax(ranks, vlm_jax):
    """DPOTrainer over 2 ranks holding 3 and 1 of the 4 pairs: each rank's
    losses and adapters equal JAX's trainer without a mesh on all 4 pairs
    (a mean of the ranks' means would miss), and the ranks end equal."""
    ranks, _ = ranks
    for res in ranks:
        losses, lora, _ = res["vlm_mesh"]["dpo_uneven"]
        np.testing.assert_allclose(losses, vlm_jax["losses"]["dpo"],
                                   atol=1e-5)
        _leaves_close(lora, vlm_jax["lora"]["dpo"], 1e-4)
    a, b = (r["vlm_mesh"]["dpo_uneven"][1] for r in ranks)
    assert all(torch.equal(a[p][n], b[p][n]) for p in a for n in ("a", "b"))


@pytest.mark.parametrize("trainer", ["vlm", "dpo", "mm"])
def test_dp_vlm_trainer_ranks_bit_equal(ranks, trainer):
    """Both ranks end on the same adapters (and projector), bit for bit,
    though the second started from other ones (the first rank's state is
    broadcast) and saw other rows (the gradients are summed)."""
    ranks, _ = ranks
    (_, a, pa), (_, b, pb) = (r["vlm_mesh"][trainer] for r in ranks)
    assert all(torch.equal(a[p][n], b[p][n]) for p in a for n in ("a", "b"))
    if trainer == "mm":
        assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("trainer", ["vlm", "dpo", "mm"])
def test_mesh_of_one_vlm_trainers_bit_identical(ranks, trainer):
    ranks, _ = ranks
    (l1, a1, p1), (l0, a0, p0) = (ranks[0][k][trainer]
                                  for k in ("one_vlm", "vlm_none"))
    assert l1 == l0
    assert all(torch.equal(a1[p][n], a0[p][n]) for p in a0 for n in ("a", "b"))
    if trainer == "mm":
        assert all(torch.equal(p1[k], p0[k]) for k in p0)
