"""The whole evaluation's share of the card's peak: the FLOPs of one image's
evaluation (the samples decoded, the metrics' products, the eval-mode loss;
``flops.eval_image``, counted from the reference) over the mean time an
image of the device-only traced window, at the configuration's peak."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    return 100.0 * ctx["flops"] / (ctx["light"].window_s / ctx["units"]) / ctx["peak_flops"]
