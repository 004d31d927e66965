"""``conv3x3_f32_3xtf32_wgmma_roofline`` read in the ProbUNet train cell, where
it moves ``step_device_ms``: the kernel's share of its roofline over the
trunk's 39 stages (13 blocks of the reference's ``blocks()``, 128x128 down
to 2x2)."""

from benchmark.harness import spec

read = spec.reader("conv3x3_f32_3xtf32_wgmma_roofline")
