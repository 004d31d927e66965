"""A model family that the benchmark does not have joins it through its own
reference module alone: a stand-in ``benchmark.reference.phiseg_deep``
(PHiSeg's model at a test size of its own, four resolution levels and three
latent levels) put into ``sys.modules``, its cell built in memory, runs its
tiny set-up, window and check through ``TrainRun`` with no other file of
the benchmark touched, and a planted fault still fails its check."""

import dataclasses
import sys
import types

import pytest

from benchmark import tiny
from benchmark.harness import check, spec
from benchmark.harness.train import TrainRun
from benchmark.reference import phiseg

FAMILY = "phiseg_deep"


@pytest.fixture
def deep_cell(monkeypatch):
    module = types.ModuleType(f"benchmark.reference.{FAMILY}")
    module.TINY = dict(filter_channels=(4, 8, 8, 8), latent_levels=3, image_size=(16, 16))
    module.build = phiseg.build
    monkeypatch.setitem(sys.modules, module.__name__, module)
    base = spec.cell("phiseg_lidc.train_bs12")
    name = f"{FAMILY}.train_bs12"
    c = dataclasses.replace(base, name=name, entry=dict(base.entry, name=name, config=FAMILY),
                            config=dict(base.config, name=FAMILY, family=FAMILY))
    return tiny.cut(c)


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_new_family_runs_from_its_own_module(deep_cell, tmp_path, fault):
    c, overrides = deep_cell
    run = TrainRun(c, tiny.SEED, "cpu", str(tmp_path), overrides, fault)
    assert (len(run.cfg.filter_channels), run.cfg.latent_levels) == (4, 3)
    run.setup()
    assert [tuple(e.shape) for e in run.draws[0]["z_eps"]] == [(4, 8, 8, 2), (4, 4, 4, 2), (4, 2, 2, 2)]
    out = run.window(0.5)
    assert out["attempted"] > c.workload["check_steps"] and out["failed"] == 0
    program = run.program_outputs()
    run.free()
    readings = run.readings(program, run.reference(program))
    assert check.verdict(readings, c.workload["limits"]) == (fault is None), readings
