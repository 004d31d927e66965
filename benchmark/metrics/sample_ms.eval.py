"""Device ms an image of the work launched under the program's span
``uz.eval.sample`` (``Trainer.eval_image``): the 100 samples decoded."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "eval", "eval.sample")
