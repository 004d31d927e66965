"""The conv-chain kernel's share of its roofline in a step: the least time
of the step's chain stages (``flops.chain_least_s``: max(FLOPs at the 3xTF32
peak, bytes at 3.35 TB/s) a stage, counted by the benchmark at the cell's
shapes) over the profiled time of the float32 chain kernel's launches.
Nothing to read where the kernel did not run."""

from benchmark.harness import flops

KERNEL = "conv3x3_f32_3xtf32_wgmma"


def read(ctx):
    if ctx["kind"] != "train" or not hasattr(ctx["model"], "blocks"):
        return None
    seconds, launches = ctx["trace"].kernel_s(KERNEL)
    if not launches:
        return None
    return 100.0 * flops.chain_least_s(ctx["model"], ctx["batch"]) * ctx["units"] / seconds
