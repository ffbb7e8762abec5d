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
- a mesh of one rank (a world of one joined through init_distributed) is
  bit-identical to no mesh for Stage 1 and the trainer;
- ImageBatchProcessor whose batched Stage 1 fails raises on every rank
  of a mesh of 2, and falls back to per-image work without a mesh.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from torch_parallel_lib import launch

RANKS = 2
SIDES = (4, 4, 5, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("paths")
    (work / "lr").mkdir()
    rng = np.random.default_rng(0)
    for i, s in enumerate(SIDES):
        Image.fromarray((rng.random((s, s, 3)) * 255).astype(np.uint8)).save(
            work / "lr" / f"tile_{i}.png")
    _write_lrhr(work / "data", rng)
    return launch("paths", RANKS, work), work


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
