"""The port's parallel layer (rsvldm_tpu_torch/parallel) on real process
groups: 4 gloo ranks on the CPU (tests/torch_parallel_lib.py, one launch
for the file), each check its own test.

- the (data=2, tile=2) mesh: its shape, tile and data groups, each rank's
  rows of a batch sharded over both axes, local_batch_range;
  make_global_mesh and its two errors (a tile group across hosts, a tile
  that does not divide the ranks);
- tile-collective GroupNorm with the tiles split over a tile group equals
  the single-process GroupNorm over all of them (atol 1e-5) and JAX's
  shard_tiled_gn_apply on its 8-device CPU mesh (atol 1e-5);
- the tiled VAE's mesh path (4 tiles over tile groups of 2) equals no mesh
  (encode and decode, 1e-5 scaled: the sharded statistics use JAX's
  E[x^2] - mean^2 formula);
- init_distributed: idempotent inside a group, False without the env;
  _order_data_axis_by_process's sort and error;
- a mesh of one rank (a world of one joined through init_distributed) is
  bit-identical to no mesh: the tiled VAE, TP decoder logits (fp32, int8,
  int4) and greedy ids; the decoder stays whole and without `tp`, and
  the captioner built over it equals the one built without a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.ops.norm import GroupNorm32 as JGroupNorm32
from rsvldm_tpu.parallel import make_mesh as jmake_mesh
from rsvldm_tpu.parallel import shard_tiled_gn_apply as jshard_gn
from rsvldm_tpu_torch.parallel.distributed import (_order_data_axis_by_process,
                                                   init_distributed)
from torch_parallel_lib import launch

RANKS = 4
RNG = np.random.default_rng(0)
GN_X = RNG.standard_normal((4, 64, 8, 8)).astype(np.float32) * 2 + 0.5
GN_W = RNG.uniform(0.5, 1.5, 64).astype(np.float32)
GN_B = RNG.uniform(-0.5, 0.5, 64).astype(np.float32)
IMG = RNG.uniform(-1, 1, (1, 3, 96, 96)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    torch.save({"gn_x": torch.from_numpy(GN_X), "gn_w": torch.from_numpy(GN_W),
                "gn_b": torch.from_numpy(GN_B), "img": torch.from_numpy(IMG)},
               work / "inputs.pt")
    return launch("parallel", RANKS, work)


def test_mesh_shape_and_groups(ranks):
    for r, res in enumerate(ranks):
        assert res["mesh_shape"] == [2, 2]
        # tile groups are rows of the rank grid, data groups its columns
        assert res["tile_group"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert res["data_group"] == [r % 2, r % 2 + 2]


def test_make_global_mesh_and_its_errors(ranks):
    """JAX's make_global_mesh rules: tile groups inside one host, 'tile'
    dividing the ranks; the same messages."""
    for r, res in enumerate(ranks):
        assert res["global_mesh"] == [[2, 2], [r // 2 * 2, r // 2 * 2 + 1]]
        pack, divide = res["global_mesh_errors"]
        assert "does not pack into hosts of 4 devices" in pack
        assert "tile=8 must divide the device count 4" in divide


def test_batch_rows_and_local_batch_range(ranks):
    for r, res in enumerate(ranks):
        assert res["batch_rows"] == [2 * r, 2 * r + 2]
        assert tuple(res["local_batch_range"]) == (2 * r, 2 * r + 2)


def test_init_distributed_idempotent_and_noop(ranks, monkeypatch):
    assert all(res["init_again"] is True for res in ranks)
    for k in ("RSVLDM_COORDINATOR", "RSVLDM_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False


def test_order_data_axis_by_process():
    arr = np.array([[2, 3], [0, 1]])
    np.testing.assert_array_equal(_order_data_axis_by_process(arr),
                                  [[0, 1], [2, 3]])
    with pytest.raises(RuntimeError, match="not process-contiguous"):
        _order_data_axis_by_process(np.array([[0, 2], [1, 3]]))


def test_sharded_gn_equals_single_process(ranks):
    for res in ranks:
        np.testing.assert_allclose(res["gn_sharded"].numpy(),
                                   res["gn_single"].numpy(), atol=1e-5)


def test_sharded_gn_equals_jax_shard_map(ranks):
    mesh = jmake_mesh(2, tile=2)
    params = {"params": {"scale": jnp.asarray(GN_W), "bias": jnp.asarray(GN_B)}}
    fn = lambda t: JGroupNorm32(epsilon=1e-6).apply(params, t)
    want = np.asarray(jax.jit(jshard_gn(fn, mesh))(
        jnp.asarray(GN_X.transpose(0, 2, 3, 1))))
    for res in ranks:
        np.testing.assert_allclose(res["gn_sharded"].numpy().transpose(0, 2, 3, 1),
                                   want, atol=1e-5)


@pytest.mark.parametrize("which", [0, 1], ids=["encode", "decode"])
def test_tiled_vae_mesh_equals_no_mesh(ranks, which):
    for res in ranks:
        got = res["vae_mesh"][which].numpy()
        want = res["vae_none"][which].numpy()
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_mesh_of_one_vae_bit_identical(ranks):
    assert ranks[0]["one_vae_equal"] is True


@pytest.mark.parametrize("mode", ["None", "int8", "int4"])
def test_mesh_of_one_decoder_bit_identical(ranks, mode):
    assert ranks[0]["one_logits_equal"][mode] is True
    assert ranks[0]["one_ids_equal"][mode] is True


@pytest.mark.parametrize("mode", ["None", "int8", "int4"])
def test_mesh_of_one_leaves_decoder_unsharded(ranks, mode):
    """A group of one keeps the decoder whole and without `tp`, so that
    its decode steps stay captured on a card; the captioner's mesh-of-one
    build equals its build without a mesh."""
    assert ranks[0]["one_tp_none"][mode] is True
    assert ranks[0]["one_captioner"][mode] == dict(equal=True, tp_none=True)
