"""Whole runs of every cell on the CPU at a tiny size, with the look for a
card skipped: the program (the port's plain CPU route) against the
reference comes out correct, and each fault the cell can have, planted
under the timed path, makes ``correct`` come out false."""

import time

import pytest

from benchmark import run, tiny
from benchmark.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
TRAIN = [n for n in CELLS if spec.cell(n).workload["kind"] == "train"]
EVAL = [n for n in CELLS if spec.cell(n).workload["kind"] == "eval"]


def _run(name, traced=False, fault=None):
    c, overrides = tiny.cell(name)
    return run.run_cell(c, tiny.SEED, 0.5, traced, "cpu", time.perf_counter(), overrides, fault)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {m["name"] for m in spec.cell(name).metrics("end_to_end")}
    assert set(result["metrics"]) == e2e
    assert list(result)[-1] == "checks"
    checks = {k: c["value"] for k, c in result["checks"].items()}
    # the reference and the port agree to float32 rounding at this size
    for key in ("loss_step1", "loss"):
        if key in checks:
            assert checks[key] < 1e-5


@pytest.mark.parametrize("name", TRAIN[:1] + EVAL)
def test_traced_run_reads_its_per_layer_metrics(name):
    result = _run(name, traced=True)
    assert result["correct"]
    assert set(result["metrics"]) <= {m["name"] for m in spec.cell(name).metrics("per_layer")}
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # a reader of the timed window that a traced run adds finds it
    for m in spec.cell(name).metrics("per_layer"):
        if getattr(spec.reader_module(m["name"]), "WINDOW", False):
            assert result["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN for f in ("unchanged", "half_batch")]
                         + [(n, f) for n in EVAL for f in ("altered_ncc", "altered_ged", "altered_dice")])
def test_planted_fault_is_not_correct(name, fault):
    assert not _run(name, fault=fault)["correct"]


def test_device_busy_merges_overlaps():
    from benchmark.harness import common

    assert common.merged_s([]) == 0.0
    assert common.merged_s([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]) == 11e-9
