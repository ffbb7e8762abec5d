"""Tiled VAE encode and decode (rsvldm_tpu/models/vae/tiled.py), NCHW.

The image (or latent) is edge-padded by a halo, cut into tiles of a fixed
size with their halos, and the tiles go through the encoder or decoder as
one batch, in one call, inside `tile_collective_gn()`: every GroupNorm
then pools its statistics over all tiles (ops/norm.py), as the JAX
package's reduction over (tile, H, W) does. Each tile's core is cropped
from the output and placed in order, a later tile overwriting the overlap
of an earlier one. Halos: 32 px at the encoder's input, 11 latent px at
the decoder's. The JAX package's mesh path (tiles sharded over devices)
is not part of the port.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ...ops.norm import tile_collective_gn

ENCODER_PAD = 32   # image-space halo
DECODER_PAD = 11   # latent-space halo


def plan_tiles(size: int, tile: int) -> list[tuple[int, int]]:
    """Tile (start, extent) pairs covering [0, size) with stride `tile`;
    the last tile is shifted left so that every tile is full."""
    if size <= tile:
        return [(0, size)]
    starts = list(range(0, size - tile, tile)) + [size - tile]
    return [(s, tile) for s in starts]


def split_tiles(x: torch.Tensor, tile: int, pad: int) -> tuple[torch.Tensor, list]:
    """[1, C, H, W] -> ([T, C, tile + 2 pad, tile + 2 pad], the grid of
    (r0, rh, c0, cw)), cut from x edge-padded by `pad`."""
    assert x.shape[0] == 1, (
        "tiled VAE is per-image: the tile axis doubles as the GroupNorm "
        "statistics pool, so a batch here would mix cross-image stats "
        f"(got batch {x.shape[0]}; run images separately)")
    _, _, h, w = x.shape
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    tiles, grid = [], []
    for r0, rh in plan_tiles(h, tile):
        for c0, cw in plan_tiles(w, tile):
            tiles.append(xp[:, :, r0:r0 + rh + 2 * pad, c0:c0 + cw + 2 * pad])
            grid.append((r0, rh, c0, cw))
    return torch.cat(tiles, dim=0), grid


def stitch_tiles(tiles: torch.Tensor, grid: list, out_hw: tuple[int, int],
                 pad: int, scale_num: int = 1, scale_den: int = 1) -> torch.Tensor:
    """Each tile's core, cropped and placed in order into [1, C, h, w].
    `scale_num / scale_den` maps image grid coordinates to the output's
    (floor division, as JAX); a placement that would overrun the edge is
    shifted in, as `dynamic_update_slice` clamps its start."""
    sc = lambda v: v * scale_num // scale_den
    h, w = out_hw
    out = tiles.new_zeros((1, tiles.shape[1], h, w))
    p = sc(pad)
    for i, (r0, rh, c0, cw) in enumerate(grid):
        core = tiles[i, :, p:p + sc(rh), p:p + sc(cw)]
        r = max(0, min(sc(r0), h - core.shape[1]))
        c = max(0, min(sc(c0), w - core.shape[2]))
        out[0, :, r:r + core.shape[1], c:c + core.shape[2]] = core
    return out


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                tile: int, pad: int, out_scale: tuple[int, int]) -> torch.Tensor:
    """fn over the halo-padded tiles of x ([1, C, H, W]) as one batch, with
    tile-collective GroupNorm, then stitched. out_scale = (num, den) is
    fn's spatial scaling (encode (1, 8), decode (8, 1))."""
    _, _, h, w = x.shape
    tiles, grid = split_tiles(x, tile, pad)
    with tile_collective_gn():
        ytiles = fn(tiles)
    del tiles
    num, den = out_scale
    return stitch_tiles(ytiles, grid, (h * num // den, w * num // den), pad,
                        num, den)


def tiled_encode(apply_encode: Callable, x: torch.Tensor, tile: int = 512,
                 pad: int = ENCODER_PAD) -> torch.Tensor:
    """apply_encode: [T, 3, h, w] -> [T, z, h/8, w/8]. 512-px tiles by
    default (RefinementConfig.encoder_tile_size)."""
    assert tile % 8 == 0 and pad % 8 == 0
    # stitch floor-divides tile starts by 8; a non-multiple extent would
    # shift the last row or column of tiles off the stride-8 grid
    assert x.shape[2] % 8 == 0 and x.shape[3] % 8 == 0, x.shape
    return tiled_apply(apply_encode, x, tile, pad, (1, 8))


def tiled_decode(apply_decode: Callable, z: torch.Tensor, tile: int = 64,
                 pad: int = DECODER_PAD) -> torch.Tensor:
    """apply_decode: [T, z, hz, wz] -> [T, 3, 8 hz, 8 wz]. 64-latent tiles
    by default (RefinementConfig.decoder_tile_size)."""
    return tiled_apply(apply_decode, z, tile, pad, (8, 1))
