"""The control of ``correct`` on the card, at each cell's own size: the
reference computed in TF32 (the nearest precision below the float32 the
configurations state) in the program's place fails at least one of the
cell's limits, on three seeds, while the program holds them all. Skipped
without a card."""

import pytest

from benchmark import calibrate
from benchmark.harness import check, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_holds(card, name):
    c = spec.cell(name)
    for seed in (901, 902, 903):
        r = calibrate.readings(c, seed, card, control=True)
        assert check.verdict(r["program"], c.workload["limits"]), r
        assert not check.verdict(r["control"], c.workload["limits"]), r
