"""Launches an evaluated image: the runtime or driver calls that put work
on the device (a kernel, copy or set each; a captured graph once), counted
in the device-only trace of the calls. The host issues each one, so this is
the host's share of an image that no device time enters."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    # the host-op trace's launches where the device-only trace kept no runtime calls
    n = ctx["light"].launches() or ctx["trace"].launches()
    return n / ctx["units"] if n else None
