"""Run one cell of BENCHMARK.json once on the card this process runs on:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (JSON: correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last `checks`, each compared number beside its
limit) and the compared numbers as the last lines of standard error.
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
ones. Exits non-zero, printing no result, without a CUDA card (or fewer
than the cell asks for), without the program, or when the process holds
JAX or the JAX package once the window has closed. `--control 1` puts the
control (the reference one precision below the configuration's) in the
program's place for the check, so that `correct` comes out false where
the limits separate the two; the program's numbers are then printed as
`also program_<name>` lines. The benchmark's runs leave it off."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "rsvldm_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (Linux: from /proc), else since
    this file began to run."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def cache_env(root: Path = ROOT) -> dict:
    """The program's build and kernel caches at fixed paths inside the
    checkout, and no JAX pulled in by libraries."""
    cache = root / ".bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is JAX's, a JAX library's or
    the JAX package's (whole names: `rsvldm_tpu_torch` is not one)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    t_start = time.perf_counter() - process_age_s()
    os.environ.update(cache_env())
    sys.path[:0] = [str(ROOT), str(BENCH)]
    import torch
    from harness import manifest
    from harness.cell import run_cell
    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell {cell['name']} needs {cell['chips']} CUDA "
              "card(s); none here, no result", file=sys.stderr)
        return 1
    try:
        import rsvldm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program is missing ({e}); no result",
              file=sys.stderr)
        return 1
    spec = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    entries = manifest.metrics_for(man, cell["name"], bool(args.trace))
    result, checks, extra = run_cell(
        spec, mix, cell, entries, args.seed, args.seconds, bool(args.trace),
        t_start, device="cuda", control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds {bad}; no result", file=sys.stderr)
        return 3
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    print(json.dumps(result), flush=True)
    for k, v in sorted(extra.items()):
        print(f"also {k} {v}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
