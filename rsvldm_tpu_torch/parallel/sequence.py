"""Sequence parallelism (SP) and a GPipe pipeline
(rsvldm_tpu/parallel/sequence.py), on torch.distributed.

JAX writes both as shard_map bodies over a mesh axis; here each rank runs
its own shard and calls the collectives over the axis's process group
(`mesh.get_group(axis)`, parallel/distributed.py):

- `sequence_parallel_attention`: each rank holds its contiguous S/n rows
  of q, k and v; K/V are all-gathered over the group (one all-gather each
  a layer, the whole SP cost) and the rank computes its rows of the
  causally masked attention at their global row offset. GQA folds into a
  grouped view of q, without repeating K/V. Plain matmuls, as JAX's
  einsum: no kernel.
- `gpipe_apply`: the collective-permute pipeline. Each rank holds one
  stage's parameters; M microbatches pass through the S stages in
  M + S - 1 ticks, the activations handed one hop along the ring each
  tick (`distributed.ppermute`), and the last stage's outputs reach every
  rank by a masked all-reduce. Bubble fraction (S - 1) / (M + S - 1).
- `stack_stage_params`: per-stage parameter dicts stacked along a new
  leading stage axis.

A one-axis mesh under any name comes from `mesh.make_mesh(axis=...)`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .distributed import all_gather, all_reduce, ppermute


def _group(mesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def sequence_parallel_attention(q, k, v, mesh, axis: str, causal: bool = True,
                                scale: float | None = None) -> torch.Tensor:
    """This rank's rows of attention with the sequence split over `axis`.

    q: [B, S/n, H, D], k/v: [B, S/n, kvh, D] (kvh divides H): the rank's
    contiguous rows, in group rank order. Returns [B, S/n, H, D]. Logits
    and softmax in fp32, the probabilities cast to v's dtype before the
    product, which sums in fp32 (JAX's preferred_element_type), then the
    result in q's dtype."""
    group, n, idx = _group(mesh, axis)
    b, s_loc, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = scale if scale is not None else d ** -0.5
    kg = all_gather(k, group, dim=1)                     # [B, S, kvh, D]
    vg = all_gather(v, group, dim=1)
    qg = q.reshape(b, s_loc, kvh, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), kg.float()) * scale
    if causal:
        rows = idx * s_loc + torch.arange(s_loc, device=q.device)[:, None]
        cols = torch.arange(s_loc * n, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, -1e30)
    w = torch.softmax(logits, dim=-1).to(vg.dtype)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w.float(), vg.float())
    return o.reshape(b, s_loc, h, d).to(q.dtype)


def _stage_slice(stage_params: dict, n: int, idx: int) -> dict:
    """This rank's stage of a stacked dict: each leaf's leading axis holds
    every stage (size n: row idx) or this rank's alone (size 1)."""
    def pick(t):
        if t.shape[0] == n:
            return t[idx]
        if t.shape[0] == 1:
            return t[0]
        raise ValueError(f"gpipe_apply: a stacked leaf of {t.shape[0]} "
                         f"stages on an axis of {n}")
    return {key: pick(t) for key, t in stage_params.items()}


def gpipe_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, mesh,
                axis: str) -> torch.Tensor:
    """y_mb[i] = stage_{S-1}(... stage_0(x_mb[i])), stage s on rank s of
    the `axis` group.

    stage_fn: (params, x) -> y with y.shape == x.shape (the GPipe
    contract); `torch.func.functional_call` over a module does.
    stage_params: a dict of tensors with a leading stage axis, S == the
    group's size, or this rank's slice of it (1).
    x_mb: [M, ...] microbatches, the same on every rank.
    Returns [M, ...], the last stage's outputs, on every rank."""
    group, n, sidx = _group(mesh, axis)
    params = _stage_slice(stage_params, n, sidx)
    m = x_mb.shape[0]
    perm = [(i, (i + 1) % n) for i in range(n)]
    acts = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(m + n - 1):
        x_in = x_mb[min(t, m - 1)] if sidx == 0 else acts
        y = stage_fn(params, x_in)
        acts = ppermute(y, group, perm)
        if t >= n - 1:   # the warm-up ticks' outputs are no microbatch's
            outs.append(y if sidx == n - 1 else torch.zeros_like(y))
    return all_reduce(torch.stack(outs), group)


def stack_stage_params(trees: list) -> dict:
    """Stack per-stage parameter dicts (the same keys and shapes) along a
    new leading stage axis, for gpipe_apply."""
    return {key: torch.stack([t[key] for t in trees]) for key in trees[0]}
