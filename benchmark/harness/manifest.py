"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json), its traffic mix (traffic/<mix>.json,
parameters only), the mix's driver (drivers/<driver>.py: the loop and the
entry point it drives, named by the mix's `driver`), the configuration's
builder (builders/<builder>.py, named by its `builder`) and each metric's
reader (metrics/<metric>.py, a function `read(run)` returning a number or
None). A new cell, mix, loop, configuration or metric is a new file; no
file here lists one by name."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path | None = None) -> dict:
    with open((bench_dir or BENCH_DIR) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end ones
    with --trace 0, its per-layer ones with --trace 1."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _module(kind: str, name: str, bench_dir: Path | None = None):
    """The module <kind>/<name>.py, loaded from its path (under BENCH_DIR
    unless `bench_dir` is given)."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}")
    path = (bench_dir or BENCH_DIR) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + re.sub(r"[.-]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path | None = None):
    """metrics/<metric>.py's `read`."""
    return _module("metrics", metric, bench_dir).read


def driver(name: str, bench_dir: Path | None = None):
    """drivers/<name>.py: the loop a traffic mix runs (harness/cell.py)."""
    return _module("drivers", name, bench_dir)


def builder(name: str, bench_dir: Path | None = None):
    """builders/<name>.py: how a configuration's system is built."""
    return _module("builders", name, bench_dir)
