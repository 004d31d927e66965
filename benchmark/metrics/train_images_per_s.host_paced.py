"""Images a second of ``Trainer.train`` in a closed loop: the quantity of
the end-to-end ``train_images_per_s``, taken as the end-to-end window takes
it, over a timed window of ``--seconds`` that a traced run adds after its
traced steps. A per-layer metric in the cells whose host paces the step,
where its runs spread too widely for any bound."""

WINDOW = True


def read(ctx):
    window = ctx.get("window")
    return window["train_images_per_s"] if window and ctx["kind"] == "train" else None
