"""Device ms a step of cuDNN's FFT-family kernels (``spans.FFT_KERNELS``)
launched under any of the program's convolution spans (``uz.conv.*``,
``ops.conv.Conv``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "conv.", spans.FFT_KERNELS)
