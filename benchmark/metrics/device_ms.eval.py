"""Device ms of one image's evaluation: the kernels and copies launched
under the span around each traced call, summed, with the host's issue and
the device's idle time taken out."""


def read(ctx):
    return ctx["trace"].device_s("image") / ctx["units"] * 1e3 if ctx["kind"] == "eval" else None
