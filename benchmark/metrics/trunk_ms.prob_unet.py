"""Device ms a step of the work launched under the program's span
``uz.prob_unet.trunk`` (``ProbUNet.forward``): the trunk's forward (the
U-Net's 13 blocks on the conv-chain kernel, pools and resizes). The
backward, which autograd's thread issues after the span has closed, is not
under it. Nothing to read where the program records no such span."""

from benchmark.harness import spans

SPAN = "prob_unet.trunk"


def read(ctx):
    got = spans.program_spans(ctx["trace"]) if ctx["kind"] == "train" else None
    if not got or SPAN not in got:
        return None
    return spans.device_s(ctx["trace"], got[SPAN]) / ctx["units"] * 1e3
