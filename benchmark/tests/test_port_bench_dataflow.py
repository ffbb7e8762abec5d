"""New cells come from new files alone, with no file of the benchmark
edited: a cell that reuses a loop needs only a traffic file (data) and its
entry in BENCHMARK.json; a cell with a loop of its own adds a driver
(drivers/<driver>.py) and, for a configuration built another way, a
builder (builders/<builder>.py); a metric adds its reader. The second kind
runs through the harness's own run on the CPU."""

import json
import shutil
import time
from pathlib import Path

import pytest

from harness import manifest
from harness.cell import Run, run_cell

BENCH = Path(manifest.__file__).resolve().parent.parent

ECHO_BUILDER = '''
def build(spec, seed):
    return {"answer": spec["answer"], "seed": seed}
'''

ECHO_DRIVER = '''
import time

from harness import manifest


def build(spec, mix, seed, work, device):
    b = manifest.builder(spec["builder"])
    return {"model": b.build(spec, seed), "mix": mix, "served": 0}


def warm_up(s):
    request(s)
    return 1


def request(s):
    s["served"] += 1
    return {"got": s["model"]["answer"] + s["mix"]["offset"]}


def window(s, seconds):
    t0 = time.perf_counter()
    records = [request(s) for _ in range(s["mix"]["requests"])]
    return records, time.perf_counter() - t0


def release(s):
    s["model"] = None


def judge(s, records, control):
    gap = max(abs(r["got"] - 42) for r in records)
    return {"echo_gap": gap + (1.0 if control else 0.0)}, {"served": s["served"]}
'''


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    before = {p.relative_to(root): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    yield root, manifest.load(BENCH.parent)
    after = {p.relative_to(root): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_new_cell_and_metric_from_files(checkout):
    root, man = checkout
    bench = root / "benchmark"
    (bench / "traffic" / "image-big.json").write_text(json.dumps(
        {"driver": "image", "clients": 1, "tile_side": 40, "kind": "fields",
         "pipeline": {"no_llava": True}}))
    (bench / "metrics" / "caption_share_pct.py").write_text(
        "def read(run):\n"
        "    t = [r['timings'] for r in run.images]\n"
        "    return 100.0 * sum(x.get('caption', 0.0) for x in t) / run.window_s\n")
    man["workloads"].append({"name": "mistral-7b.image-big",
                             "config": "rsvldm-mistral-7b",
                             "traffic": "image-big", "chips": 1,
                             "why": "bigger tiles"})
    man["per_layer"].append({"name": "caption_share_pct", "unit": "%",
                             "better": "lower", "source": "program_span",
                             "layer": "caption", "moves": "image_s",
                             "workloads": ["mistral-7b.image-big"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    man2 = manifest.load(root)
    cell = manifest.cell(man2, "mistral-7b.image-big")
    spec = manifest.config(man2, cell["config"], root)
    mix = manifest.traffic(cell["traffic"])
    assert mix["tile_side"] == 40 and spec["name"] == "rsvldm-mistral-7b"
    assert manifest.driver(mix["driver"]).__file__.startswith(str(bench))
    entries = manifest.metrics_for(man2, cell["name"], True)
    assert "caption_share_pct" in [m["name"] for m in entries]
    run = Run(spec, cell, [{"timings": {"caption": 2.0}}], 10.0, 1.0, 0)
    assert manifest.reader("caption_share_pct")(run) == 20.0


def test_new_loop_and_builder_from_files(checkout):
    root, man = checkout
    bench = root / "benchmark"
    (bench / "builders" / "echo.py").write_text(ECHO_BUILDER)
    (bench / "drivers" / "echo.py").write_text(ECHO_DRIVER)
    (bench / "traffic" / "echo-burst.json").write_text(json.dumps(
        {"driver": "echo", "requests": 5, "offset": 2}))
    (bench / "configs" / "echo-small.json").write_text(json.dumps(
        {"name": "echo-small", "builder": "echo", "answer": 40, "reduced": [],
         "limits": {"echo_gap": 0.5}}))
    man["configs"].append({"name": "echo-small", "source": "a test",
                           "file": "benchmark/configs/echo-small.json",
                           "reduced": [], "why": "a loop of its own"})
    man["workloads"].append({"name": "echo-small.burst", "config": "echo-small",
                             "traffic": "echo-burst", "chips": 4,
                             "why": "five requests a window"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    man2 = manifest.load(root)
    cell = manifest.cell(man2, "echo-small.burst")
    spec = manifest.config(man2, cell["config"], root)
    mix = manifest.traffic(cell["traffic"])
    for control in (False, True):
        result, checks, extra = run_cell(
            spec, mix, cell, [], 7, 0.0, False, time.perf_counter(),
            device="cpu", control=control, work=root / "work")
        assert result["correct"] is not control
        assert result["attempted"] == 5 and result["device"]["count"] == 4
        assert checks == [("echo_gap", 1.0 if control else 0.0, 0.5)]
        assert extra == {"served": 6}
