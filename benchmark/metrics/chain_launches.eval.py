"""Launches an evaluated image of the float32 conv-chain kernel
(``conv3x3_f32_3xtf32_wgmma``), counted by the kernel's name in the
device-only trace of the evaluation: every stage of the eval-mode BatchNorm
sequences that fold into the kernel (``ConvSeq.folds``), 173 a
``phiseg_7_5_12`` image (the sample's 67, the eval-mode loss's 106). A
program whose evaluation does not fold reads 0."""

KERNEL = "conv3x3_f32_3xtf32_wgmma"


def read(ctx):
    return ctx["light"].kernel_s(KERNEL)[1] / ctx["units"] if ctx["kind"] == "eval" else None
