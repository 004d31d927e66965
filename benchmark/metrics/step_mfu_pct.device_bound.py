"""``step_mfu_pct.train`` read in the device-bound train cells, where it moves
``train_images_per_s.device_bound``."""

from benchmark.harness import spec

read = spec.reader("step_mfu_pct.train")
