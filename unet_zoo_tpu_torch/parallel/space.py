"""Spatial sharding (the mesh's "space" axis), the twin of
``unet_zoo_tpu.parallel.space``.

The JAX package shards the image height over a "space" axis and pins
activations to it at the conv, pool, resize and reversible outputs, so that
XLA halo-exchanges the convs. In the port, the space axis is queued
(``ROADMAP.md``): it needs a halo exchange over NCCL around every conv,
pool and resize output. Every registered configuration fits one H100 80GB
at its registered batch without it (``PERF.md`` section 6: the largest,
``phiseg_uzh_7_5_512`` plain in float32 with TF32 off, peaks at 48972.5 MiB
a step), so at space 1 both hooks here do nothing and at space > 1 they
raise. ``make_mesh`` and the CLIs call ``check_space``; ``space_sharding``
and ``constrain`` keep the JAX package's names for scripts written against
them, and take effect when the space axis is built.
"""

from __future__ import annotations

import contextlib

SPACE_NOT_BUILT = ("spatial sharding (space > 1) is not built in the PyTorch port: it needs a halo exchange over "
                   "NCCL around the conv, pool and resize outputs, and is queued in ROADMAP.md. Every registered "
                   "configuration fits one H100 80GB at its registered batch (PERF.md: phiseg_uzh_7_5_512 plain, "
                   "float32 with TF32 off, peaks at 48972.5 MiB a step); run with space=1")


def check_space(space: int) -> None:
    """Raises ``NotImplementedError`` for a space axis above 1."""
    if space > 1:
        raise NotImplementedError(SPACE_NOT_BUILT)


@contextlib.contextmanager
def space_sharding(mesh):
    """No-op where ``mesh`` is None or its space axis is 1; raises above 1."""
    check_space(1 if mesh is None else mesh.space)
    yield


def constrain(x):
    """The identity: at space 1 no activation is pinned."""
    return x
