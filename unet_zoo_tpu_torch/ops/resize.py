"""Resize ops, the twins of ``unet_zoo_tpu.ops.resize``.

The JAX package contracts small interpolation matrices because gathers are
slow on a TPU; ``F.interpolate`` has the same semantics (the JAX tests pin
their op against it) and is used directly. Sizes are always explicit, never
a ``scale_factor``, so odd pyramids resize to the skip's exact shape.
Gradients are autograd's through ``F.interpolate``: the transpose of the
same interpolation map that the JAX package's custom VJP contracts with
pre-transposed matrices; ``tests/test_torch_ops.py`` holds the two together.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _check_nhwc(x: torch.Tensor, out_size: Sequence[int]) -> None:
    if x.ndim != 4 or len(out_size) != 2:
        raise ValueError(
            f"expected NHWC input and a 2-d size, got {tuple(x.shape)} -> {tuple(out_size)}"
        )


def resize_linear(x: torch.Tensor, out_size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NHWC input to the spatial size ``out_size``."""
    _check_nhwc(x, out_size)
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(out_size), mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, out_size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC input (torch 'nearest' index rule)."""
    _check_nhwc(x, out_size)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_size), mode="nearest")
    return y.permute(0, 2, 3, 1)
