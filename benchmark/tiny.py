"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the same files, the model at the size its reference module states
(``TINY``), a few images."""

import dataclasses

from benchmark.harness import common, spec

SEED = 2 ** 31 + 7  # past 32 signed bits, as the seeds the runs are given


def cell(name: str):
    """(cell, overrides) of ``name`` at the tests' size."""
    return cut(spec.cell(name))


def cut(c: spec.Cell):
    """(cell, overrides) of the cell ``c`` at the tests' size."""
    overrides = dict(common.family(c).TINY)
    w = dict(c.workload, data={"train": 40, "test": 6}, chunk_steps=2, trace_steps=2)
    if w["kind"] == "train":
        overrides["batch_size"] = 4
    else:
        w.update(samples=4, statistics_images=4, check_images=3, trace_images=2)
    return dataclasses.replace(c, workload=w), overrides
