"""Device ms a step of the work launched under the program's span
``uz.prob_unet.posterior`` (``ProbUNet.forward``): the posterior net's
forward (the one-hot mask, its BatchNorm encoder, spatial mean and head).
The backward, which autograd's thread issues after the span has closed, is
not under it. Nothing to read where the program records no such span."""

from benchmark.harness import spans

SPAN = "prob_unet.posterior"


def read(ctx):
    got = spans.program_spans(ctx["trace"]) if ctx["kind"] == "train" else None
    if not got or SPAN not in got:
        return None
    return spans.device_s(ctx["trace"], got[SPAN]) / ctx["units"] * 1e3
