"""The loops' step runner for the reference: every step is called
directly (the port captures and replays them as CUDA graphs; the steps'
arithmetic is the same)."""

from __future__ import annotations

from typing import Callable


def use_graphs(device, graphs) -> bool:
    return False


class StepRunner:
    def __init__(self, fn: Callable, graphs: bool = False, counters=None):
        self.fn = fn
        self.capture_s = 0.0

    def __call__(self, *args):
        return self.fn(*args)
