"""Resize ops, the twins of ``unet_zoo_tpu.ops.resize``.

The JAX package contracts small interpolation matrices because gathers are
slow on a TPU; ``F.interpolate`` has the same semantics (the JAX tests pin
their op against it) and is used directly, bilinear on NHWC and trilinear on
NDHWC input. Sizes are always explicit, never a ``scale_factor``, so odd
pyramids resize to the skip's exact shape. Gradients are autograd's through
``F.interpolate``: the transpose of the same interpolation map that the JAX
package's custom VJP contracts with pre-transposed matrices;
``tests/test_torch_ops.py`` and ``tests/test_torch_ops3d.py`` hold the two
together.

Under spatial sharding (``parallel/space.py``) ``out_size`` is the global
size. The height is resized by ``space.resize_height``: this process's rows
of the interpolation matrix on the input rows they read (its own and a
1-row halo for a 2x upsample, the gathered input otherwise; a nearest
upsample by an integer ratio reads its own rows only); the other axes then
by their interpolation matrices (``space.resize_axis``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.parallel import space as space_lib

_LINEAR = {4: "bilinear", 5: "trilinear"}


def _check(x: torch.Tensor, out_size: Sequence[int]) -> None:
    if x.ndim not in _LINEAR or len(out_size) != x.ndim - 2:
        raise ValueError(
            f"expected NHWC or NDHWC input and a size per spatial axis, got {tuple(x.shape)} -> {tuple(out_size)}"
        )


def resize_linear(x: torch.Tensor, out_size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Bi- or trilinear resize of NHWC / NDHWC input to the spatial size ``out_size``."""
    _check(x, out_size)
    if space_lib.current() is not None:
        return _sharded(x, out_size, "linear", align_corners)
    y = F.interpolate(x.movedim(-1, 1), size=tuple(out_size), mode=_LINEAR[x.ndim], align_corners=align_corners)
    return y.movedim(1, -1)


def upsample_nearest(x: torch.Tensor, out_size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC / NDHWC input (torch 'nearest' index rule)."""
    _check(x, out_size)
    if space_lib.current() is not None:
        return _sharded(x, out_size, "nearest")
    return F.interpolate(x.movedim(-1, 1), size=tuple(out_size), mode="nearest").movedim(1, -1)


def _sharded(x: torch.Tensor, out_size: Sequence[int], mode: str, align_corners=None) -> torch.Tensor:
    """The resize under spatial sharding: the height, then each other axis."""
    y = space_lib.resize_height(x, out_size[0], mode, align_corners)
    for axis, size in enumerate(out_size[1:], start=2):
        y = space_lib.resize_axis(y, axis, size, mode, align_corners)
    return y
