"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the same files, the model at a few channels and 16x16, a few images."""

import dataclasses

from benchmark.harness import spec

SEED = 2 ** 31 + 7  # past 32 signed bits, as the seeds the runs are given


def cell(name: str):
    """(cell, overrides) of ``name`` at the tests' size."""
    c = spec.cell(name)
    if c.config["family"] == "phiseg":
        overrides = dict(filter_channels=(4, 8, 8), latent_levels=2, image_size=(16, 16))
    else:
        overrides = dict(filter_channels=(4, 8), image_size=(16, 16))
    w = dict(c.workload, data={"train": 40, "test": 6}, chunk_steps=2, trace_steps=2)
    if w["kind"] == "train":
        overrides["batch_size"] = 4
    else:
        w.update(samples=4, statistics_images=4, check_images=3, trace_images=2)
    return dataclasses.replace(c, workload=w), overrides
