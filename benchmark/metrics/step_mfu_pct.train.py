"""The whole step's share of the card's peak: the FLOPs of a step's forward
and backward, counted by the benchmark from the reference at the cell's
shapes (``flops.train_step``), over the mean step time of the device-only
traced window of ``Trainer.train``, at the configuration's peak (float32:
3xTF32, 164.9 TFLOP/s)."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return 100.0 * ctx["flops"] / (ctx["light"].window_s / ctx["units"]) / ctx["peak_flops"]
