"""Ceil-mode average pool, the twin of ``unet_zoo_tpu.ops.pool.avg_pool_ceil``.

torch's ``AvgPool2d(kernel=2, stride=2, ceil_mode=True)`` divides each window
by the number of in-bounds elements, which is the semantics the JAX op
reproduces by hand; here the library op is used directly. Its gradient is
autograd's through ``F.avg_pool2d``, which spreads each output's cotangent
over its window with the same 1/count: the JAX package's custom VJP
(``unet_zoo_tpu/ops/pool.py``, the pre-transposed averaging matrices)
computes the same map, and ``tests/test_torch_ops.py`` holds the two
together.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """Ceil-mode 2x2, stride-2 average pool over the spatial axes of NHWC input.

    A contiguous NHWC tensor permuted to NCHW is a ``channels_last`` view,
    which ``F.avg_pool2d`` takes and returns without a copy.
    """
    if x.ndim != 4:
        raise ValueError(f"avg_pool_ceil takes NHWC input, got shape {tuple(x.shape)}")
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)
