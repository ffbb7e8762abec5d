"""Loop steps as CUDA graphs: the port's counterpart of the JAX package's
`lax.scan` loops (the caption decode, SR3, RestoreEDM).

A loop step is one function of no arguments (or of fixed tensors) that
reads and writes tensors the loop owns, in place: its state advances on
the device, with no host read inside it. `StepRunner` drives it:
- on the CPU, and on the card with `graphs=False`, every call runs the
  function directly;
- on the card, the first call runs it directly (a real step, which also
  warms up cuBLAS, the kernels' builds and their bindings), the second
  captures it into a `torch.cuda.CUDAGraph` and replays it, and every
  later call replays it.
So one body serves both ways, and the tests on the CPU reach the code the
card replays. A failed capture raises; nothing falls back to direct calls.

Launch counters (`flash_attention.launches`, `int4_matmul.launches`) are
Python counters that the wrappers add to where they launch: during a
capture they count the launches recorded, though none runs then. The
runner takes that increase back after the capture and adds it again at
every replay, so a counter still counts the kernels that ran.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def kernel_counters() -> tuple:
    """The hand kernels' wrappers, whose `launches` attribute counts."""
    from ..ops.flash_attention import flash_attention, flash_attention_bwd
    from ..ops.quant import int4_matmul
    return (flash_attention, flash_attention_bwd, int4_matmul)


def use_graphs(device: torch.device, graphs: bool | None) -> bool:
    """Whether loops on `device` replay graphs: by default on CUDA only;
    graphs on the CPU raise."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return bool(graphs)


class StepRunner:
    """Runs `fn(*args)`: directly, or (with `graphs`) directly once, then as
    a captured graph. `capture_s` holds the capture's seconds (0 until it
    happens); `replays` counts replays. Replays return the tensors the
    capture returned, which the next replay overwrites: copy what must
    outlive it. The args of a replay must be the capture's own objects."""

    def __init__(self, fn: Callable, graphs: bool,
                 counters: Sequence | None = None):
        self.fn = fn
        self.graphs = graphs
        self.counters = tuple(kernel_counters() if counters is None
                              else counters)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.calls = 0
        self.replays = 0
        self.capture_s = 0.0
        self._args: tuple = ()
        self._out = None
        self._per_replay: tuple = ()

    def __call__(self, *args):
        self.calls += 1
        if not self.graphs or self.calls == 1:
            return self.fn(*args)
        if self.graph is None:
            self._capture(args)
        elif len(args) != len(self._args) or any(
                a is not b for a, b in zip(args, self._args)):
            raise ValueError("StepRunner: a replay reads the tensors of its "
                             "capture; other arguments were given")
        self.graph.replay()
        self.replays += 1
        for c, n in zip(self.counters, self._per_replay):
            c.launches += n
        return self._out

    def _capture(self, args):
        t0 = time.perf_counter()
        before = [c.launches for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.fn(*args)
        torch.cuda.synchronize()
        # the capture recorded these launches without running them
        self._per_replay = tuple(c.launches - b
                                 for c, b in zip(self.counters, before))
        for c, b in zip(self.counters, before):
            c.launches = b
        self.graph, self._args, self._out = graph, args, out
        self.capture_s = time.perf_counter() - t0
