"""Launches a step of the float32 conv-chain kernel
(``conv3x3_f32_3xtf32_wgmma``), counted by the kernel's name in the
device-only trace of ``Trainer.train``'s steps: 39 in a ProbUNet step (the
trunk's 13 blocks of 3 stages). A trunk that left the kernel reads 0."""

KERNEL = "conv3x3_f32_3xtf32_wgmma"


def read(ctx):
    return ctx["light"].kernel_s(KERNEL)[1] / ctx["units"] if ctx["kind"] == "train" else None
