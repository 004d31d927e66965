"""``step_mfu_pct.train`` read in the ProbUNet train cell, where it moves
``step_device_ms``."""

from benchmark.harness import spec

read = spec.reader("step_mfu_pct.train")
