"""Share of the device-only traced window (the evaluated images, timed by
the host's clock) in which no kernel, copy or set ran on the device."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    t = ctx["light"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
