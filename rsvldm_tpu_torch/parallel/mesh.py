"""Device mesh and batch-sharding helpers (rsvldm_tpu/parallel/mesh.py).

The mesh is a `torch.distributed.device_mesh.DeviceMesh` of dims
("data", "tile") over the ranks of the world, one rank per device:

  'data' - batch and folder parallelism (each rank runs the whole Stage 1
           on its rows of the batch; the SR3 trainer all-reduces its
           gradients) and the captioner's tensor parallelism
           (parallel/llama_sharding.py), as in the JAX package;
  'tile' - the tiled VAE's tiles of one image, split over the group, whose
           GroupNorm statistics are all-reduced at every norm
           (ops/norm.py).

Where XLA inserts collectives from sharding annotations in JAX, the port
calls them itself over `mesh.get_group(...)` (parallel/distributed.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.norm import tile_collective_gn
from .distributed import (all_gather, broadcast, init_world_of_one,
                          mesh_from_ranks, world)


def make_mesh(n_devices: int | None = None, tile: int = 1):
    """Mesh of shape (data, tile) over the world's ranks; tile divides
    them. The mesh spans every rank (n_devices, when given, must be the
    world size); a world of one is made when no process group exists."""
    init_world_of_one()
    n = world()[1]
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}): a mesh spans every rank "
                         f"of the world ({n}); start {n_devices} ranks")
    assert n % tile == 0, (n, tile)
    return mesh_from_ranks(np.arange(n).reshape(n // tile, tile))


def mesh_size(mesh) -> int:
    return int(np.prod(mesh.shape))


def mesh_index(mesh) -> int:
    """This rank's index in the flattened (data, tile) order, the order in
    which P(("data", "tile")) lays out batch rows."""
    d, t = mesh.get_coordinate()
    return d * mesh.shape[1] + t


def batch_sharding(mesh, global_batch: int) -> slice:
    """This rank's contiguous rows of a global batch sharded over both mesh
    axes (P(("data", "tile"))); the batch must divide the mesh."""
    n = mesh_size(mesh)
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide the "
                         f"{n}-rank mesh")
    per = global_batch // n
    i = mesh_index(mesh)
    return slice(i * per, (i + 1) * per)


def put_batch(mesh, x):
    """This rank's rows of the global batch x (`batch_sharding`)."""
    return x[batch_sharding(mesh, x.shape[0])]


def mesh_group(mesh):
    """The process group of the whole mesh (both axes)."""
    if mesh.shape[1] == 1:
        return mesh.get_group("data")
    if mesh.shape[0] == 1:
        return mesh.get_group("tile")
    import torch.distributed as dist
    return dist.group.WORLD


def replicate(mesh, t: torch.Tensor) -> torch.Tensor:
    """t broadcast in place from the mesh's first rank to all of them."""
    return broadcast(t, mesh_group(mesh), 0)


def replicate_state(mesh, tree):
    """Every tensor of `tree` (a module, a dict, a list or tuple of them)
    broadcast in place from the mesh's first rank: the state of the ranks
    is then equal whatever each one started from. Returns tree."""
    if isinstance(tree, torch.nn.Module):
        for t in tree.state_dict().values():
            replicate(mesh, t)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate_state(mesh, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate_state(mesh, v)
    elif isinstance(tree, torch.Tensor):
        replicate(mesh, tree)
    return tree


def shard_tiled_gn_apply(fn: Callable, mesh, axis: str = "tile"):
    """Wrap a tile-batched VAE apply ([T, C, h, w] -> [T, C', h', w']): each
    rank of the `axis` group runs its contiguous T/n tiles inside
    tile_collective_gn(group) (GroupNorm statistics all-reduced over the
    group, JAX's pmean formula), and the outputs are gathered in tile
    order on every rank. T must divide the group."""
    group = mesh.get_group(axis)
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)

    def apply(tiles: torch.Tensor) -> torch.Tensor:
        t = tiles.shape[0]
        if t % n:
            raise ValueError(f"{t} tiles do not divide the {axis} group of {n}")
        per = t // n
        with tile_collective_gn(group):
            y = fn(tiles[r * per:(r + 1) * per])
        return all_gather(y, group, 0)

    return apply
