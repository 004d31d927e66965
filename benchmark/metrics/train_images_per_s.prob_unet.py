"""``train_images_per_s.host_paced`` read in the ProbUNet train cell, where it
moves ``step_device_ms``: images a second of ``Trainer.train`` in a closed
loop, over the timed window that a traced run adds."""

from benchmark.harness import spec

_rate = spec.reader_module("train_images_per_s.host_paced")
WINDOW, read = _rate.WINDOW, _rate.read
