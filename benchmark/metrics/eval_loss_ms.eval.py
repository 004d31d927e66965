"""Device ms an image of the work launched under the program's span
``uz.eval.loss`` (``Trainer.eval_image``): the eval-mode forward and loss."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "eval", "eval.loss")
