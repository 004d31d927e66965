"""Device ms a step of the kernels launched under the span around
``Trainer.augment`` (the upload's copies are the upload span's)."""


def read(ctx):
    return ctx["trace"].device_s("augment") / ctx["units"] * 1e3 if ctx["kind"] == "train" else None
