"""On the card, at each cell's own size: the control (the reference one
precision below, `--control 1`) in the program's place comes out not
correct through run.py itself, on three seeds, while the program's own
numbers of the same run stay within the configuration's limits. Run on
the machine with the card:

    python -m pytest benchmark/tests -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness import manifest

BENCH = Path(manifest.__file__).resolve().parent.parent
SEEDS = (2 ** 31 + 7001, 2 ** 31 + 7002, 2 ** 31 + 7003)
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _run(cell: str, seed: int):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          cell, "--seed", str(seed), "--seconds", "1",
                          "--control", "1"], capture_output=True, text=True,
                         timeout=900, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    program = {}
    for line in out.stderr.splitlines():
        if line.startswith("also program_"):
            _, name, value = line.split()
            program[name[len("program_"):]] = float(value)
    return result, program


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_where_the_program_is(card, cell):
    for seed in SEEDS:
        result, program = _run(cell, seed)
        assert result["correct"] is False, result["checks"]
        assert any(c["value"] > c["limit"] for c in result["checks"].values())
        assert set(program) == set(result["checks"])
        assert all(program[n] <= c["limit"]
                   for n, c in result["checks"].items()), program
