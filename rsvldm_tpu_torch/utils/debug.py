"""NaN guards and profiling hooks (rsvldm_tpu/utils/debug.py) in torch:
finite checks on tensors and nested state, a stage timer that waits for
the card and reports its allocated memory, and a torch.profiler scope that
writes a Chrome trace."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any

import torch

log = logging.getLogger("rsvldm_torch")


class NansException(Exception):
    pass


_HINTS = {
    "unet": "try a different precision (bf16) or checkpoint",
    "vae": "use an fp32 / bf16 VAE: fp16 gives NaNs in the autoencoder",
}


def test_for_nans(x: torch.Tensor, where: str = "unet") -> None:
    """Raise NansException when any value of x is not finite."""
    if not bool(torch.isfinite(x).all()):
        raise NansException(
            f"non-finite values produced in {where}; {_HINTS.get(where, '')}")


def tree_finite(tree) -> bool:
    """Whether every floating tensor in a nested dict / list / tuple (a state
    dict, a module's outputs) is finite; other leaves are ignored."""
    if isinstance(tree, torch.Tensor):
        return not tree.is_floating_point() or bool(torch.isfinite(tree).all())
    if isinstance(tree, dict):
        return all(tree_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_finite(v) for v in tree)
    return True


@contextlib.contextmanager
def stage_timer(name: str, sync: Any | None = None):
    """Wall-clock a stage: yields a dict (set "out" in it to name the result
    to wait for); on exit waits for the card (a stream synchronize, when
    the result or `sync` lies on CUDA), logs the seconds and the card's
    allocated memory, and stores "seconds" in the dict."""
    t0 = time.perf_counter()
    holder: dict = {}
    try:
        yield holder
    finally:
        out = holder.get("out", sync)
        cuda = isinstance(out, torch.Tensor) and out.is_cuda
        if cuda:
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        mem = ""
        if cuda:
            mem = (f", {torch.cuda.memory_allocated(out.device) / 2**20:.0f} "
                   "MiB allocated")
        log.info("[%s] %.3fs%s", name, dt, mem)
        holder["seconds"] = dt


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA when there is a card);
    on exit writes `logdir`/trace.json, a Chrome trace. Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
