"""Ceil-mode average pool, the twin of ``unet_zoo_tpu.ops.pool.avg_pool_ceil``.

torch's ``AvgPool2d``/``AvgPool3d(kernel=2, stride=2, ceil_mode=True)``
divides each window by the number of in-bounds elements, which is the
semantics the JAX op reproduces by hand; here the library op is used
directly. Its gradient is autograd's through ``F.avg_pool2d``/``3d``, which
spreads each output's cotangent over its window with the same 1/count: the
JAX package's custom VJP (``unet_zoo_tpu/ops/pool.py``, the pre-transposed
averaging matrices) computes the same map, and ``tests/test_torch_ops.py``
and ``tests/test_torch_ops3d.py`` hold the two together.

Under spatial sharding (``parallel/space.py``) a sharded input of even
local height pools its own rows into its own rows of the output, whose
global height then splits evenly too. Otherwise (an odd local height, a
replicated input) the input is gathered, pooled whole, and the output
keeps this process's rows where its global height splits evenly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.parallel import space as space_lib

_POOLS = {4: F.avg_pool2d, 5: F.avg_pool3d}


def avg_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """Ceil-mode 2x2(x2), stride-2 average pool over the spatial axes of NHWC
    or NDHWC input.

    A contiguous channels-last tensor with its channels moved to axis 1 is a
    ``channels_last``/``channels_last_3d`` view, which the library pool takes
    and returns without a copy. The library op needs every spatial axis at
    2 or more (the JAX op also pools an axis of 1); ``ExperimentConfig.validate``
    keeps every pooled axis there.
    """
    if x.ndim not in _POOLS:
        raise ValueError(f"avg_pool_ceil takes NHWC or NDHWC input, got shape {tuple(x.shape)}")
    sp = space_lib.current()
    if sp is None:
        return _pool(x)
    if sp.is_sharded(x):
        if x.shape[1] % 2 == 0:
            return _pool(x)
        x = sp.gather(x)
    return sp.constrain(_pool(x))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return _POOLS[x.ndim](x.movedim(-1, 1), 2, 2, ceil_mode=True).movedim(1, -1)
