"""One run of one cell, whatever its traffic: the mix's driver
(drivers/<driver>.py, named by the mix's file) builds the system under
test from the configuration, warms it up at the cell's shapes, serves the
measured window by its own loop and judges its answers; this module holds
what every cell shares. The card's peak is reset at the start, so set-up
and window both count; set-up ends with the warm-up; with trace, one
request after set-up and before the window runs under the profiler. Then
the peak is read, the system freed, each metric's reader
(metrics/<metric>.py) reads the run, and the driver's numbers are held to
the configuration's `limits`: `correct` is that every number is within
its limit. With control, the driver puts the control's numbers in the
program's place, and the same comparison judges them."""

from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import manifest, trace as tracing


@dataclasses.dataclass
class Run:
    """What a run saw, for the metric readers (metrics/<name>.py)."""
    spec: dict
    cell: dict
    images: list            # the window's request records, in order
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: dict | None = None   # the profiled request's reduced trace
    traced: dict | None = None  # the profiled request's record


def _say(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _gib(device) -> str:
    return f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB"


def run_cell(spec: dict, mix: dict, cell: dict, metric_entries: list,
             seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", control: bool = False, work: Path | None = None):
    """(result, checks, extra): the result line's fields, the compared
    numbers [(name, value, limit)] and the other readings of the check.
    The run's files go to `work`, by default a directory under TMPDIR
    removed at the end."""
    if work is not None:
        return _run_cell(spec, mix, cell, metric_entries, seed, seconds,
                         trace, t_start, device, control, Path(work))
    work = Path(tempfile.mkdtemp(prefix="rsvldm_bench_"))
    try:
        return _run_cell(spec, mix, cell, metric_entries, seed, seconds,
                         trace, t_start, device, control, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def limit_checks(numbers: dict, limits: dict) -> tuple:
    """(checks [(name, value, limit)], correct): every number within its
    limit, and at least one number; a number without a limit fails."""
    checks = [(n, float(v), limits.get(n)) for n, v in numbers.items()]
    correct = bool(checks) and all(lim is not None and v <= lim
                                   for _, v, lim in checks)
    return checks, correct


def _run_cell(spec, mix, cell, metric_entries, seed, seconds, trace,
              t_start, device, control, work: Path):
    driver = manifest.driver(mix["driver"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter()
    system = driver.build(spec, mix, seed, work, dev)
    _say(f"built in {time.perf_counter() - t_build:.2f} s, "
         f"{time.perf_counter() - t_start:.2f} s after the process start"
         + (f", peak so far {_gib(dev)}" if on_card else ""))
    warm = driver.warm_up(system)
    setup_s = time.perf_counter() - t_start
    _say(f"{warm} warm-up request(s), set-up {setup_s:.2f} s"
         + (f", peak so far {_gib(dev)}" if on_card else ""))

    run_trace = traced = None
    if trace:
        with tracing.profiled() as run_trace:
            traced = driver.request(system)

    records, window_s = driver.window(system, seconds)
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    driver.release(system)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    run = Run(spec, cell, records, window_s, setup_s, peak, run_trace, traced)
    metrics = {}
    # a run without the card reports no metric: none of them means
    # anything off the card
    for m in metric_entries if on_card else ():
        v = manifest.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    _say(f"window {window_s:.2f} s, {len(records)} request(s)")
    describe = getattr(driver, "describe", None)
    for r in records if describe else ():
        _say(describe(r))
    t_check = time.perf_counter()
    numbers, extra = driver.judge(system, records, control)
    _say(f"{'control' if control else 'reference'} check in "
         f"{time.perf_counter() - t_check:.2f} s")
    checks, correct = limit_checks(numbers, spec.get("limits", {}))
    result = {"correct": correct, "attempted": len(records),
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": int(cell.get("chips", 1)),
                         "memory_peak_bytes": peak}}
    if run_trace is not None:
        result["device"]["busy_s"] = run_trace["busy_s"]
        result["device"]["window_s"] = traced["wall_s"]
        result["breakdown"] = {
            "device_ops": [list(x) for x in tracing.top(run_trace["by_name"])],
            "idle_gaps": [list(x) for x in run_trace["gaps"]]}
    return result, checks, extra
