"""Host ms of ``LIDCData``'s ``train.next_batch(batch)``: the median over the
traced steps (host clock around the call)."""


def read(ctx):
    return ctx.get("next_batch_ms") if ctx["kind"] == "train" else None
