"""Ms a step in which the device ran nothing while one of the program's
convolution spans (``uz.conv.*``, ``ops.conv.Conv``) was open on the host:
the device waiting on the convolutions' launches."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "conv.", idle=True)
