"""Device ms a step of the kernels launched under the spans around
``Trainer.backward`` and ``Trainer.update``: the backward, the plateau
scheduler and Adam."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    t = ctx["trace"]
    return (t.device_s("backward") + t.device_s("update")) / ctx["units"] * 1e3
