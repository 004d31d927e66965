"""Device ms a step of the kernels launched under the span around
``Trainer.forward_loss``: the model's forward and its loss."""


def read(ctx):
    return ctx["trace"].device_s("forward_loss") / ctx["units"] * 1e3 if ctx["kind"] == "train" else None
