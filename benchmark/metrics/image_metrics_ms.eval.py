"""Device ms an image of the work launched under the program's span
``uz.eval.metrics`` (``Trainer.eval_image``): GED, variance-NCC and Dice of
the samples."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "eval", "eval.metrics")
