"""BENCHMARK.json against the benchmark's contract: names, units, the
files each entry names, and each per-layer metric's end-to-end metric
reported in every cell that lists it."""

import json
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_top_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in man["command"])


def test_names_and_units(man):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    assert len(set(names)) == len(names)
    metric_names = [e["name"] for k in ("end_to_end", "per_layer")
                    for e in man[k]]
    assert len(set(metric_names)) == len(metric_names)


def test_files_found_by_name(man):
    for c in man["configs"]:
        spec = manifest.config(man, c["name"])
        assert spec["name"] == c["name"]
        assert spec["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/configs/")
        builder = manifest.builder(spec["builder"])
        assert callable(builder.build)
    for w in man["workloads"]:
        driver = manifest.driver(manifest.traffic(w["traffic"])["driver"])
        for fn in ("build", "warm_up", "request", "window", "release", "judge"):
            assert callable(getattr(driver, fn)), (w["traffic"], fn)
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_moves_reported_where_listed(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"]


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(man, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(man, w["name"], True)


def test_size(man):
    assert len(json.dumps(man)) < 64 * 1024
