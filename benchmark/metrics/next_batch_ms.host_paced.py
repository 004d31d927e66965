"""``next_batch_ms.train`` read in the host-paced train cells, where it moves
``step_device_ms``."""

from benchmark.harness import spec

read = spec.reader("next_batch_ms.train")
