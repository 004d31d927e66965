"""BENCHMARK.json and the files it names: the contract's shape, names and
units, every file found by name, and each configuration file stating the
port's registered experiment."""

import math
import os
import re

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/") and ".." not in path
        assert not path.endswith("_torch") and os.path.isdir(os.path.join(spec.ROOT, path))
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(spec.ROOT, BENCH["command"][1]))


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if metric in BENCH["end_to_end"] else
                                                   {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        # every cell that reports the metric reports the end-to-end metric it moves
        assert set(metric.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics", f"{metric['name']}.py"))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics(name):
    c = spec.cell(name)
    assert c.entry["chips"] in (1, 4) and LINE.match(c.entry["why"]) and NAME.match(c.entry["traffic"])
    e2e = [m["name"] for m in c.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics("per_layer")
    assert c.workload["kind"] in ("train", "eval")
    for key, limit in c.workload["limits"].items():
        assert NAME.match(key) and math.isfinite(limit) and limit >= 0
    spec.experiment(c)  # raises where the registry no longer runs what the configuration file states


def test_pairs_configs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for conf in BENCH["configs"]:
        assert conf["name"] in used and set(conf) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(conf["source"]) and LINE.match(conf["why"]) and len(conf["reduced"]) <= 16
        assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert spec.load_json(os.path.join(spec.ROOT, conf["file"]))["name"] == conf["name"]


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
