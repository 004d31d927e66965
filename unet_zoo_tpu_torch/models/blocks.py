"""Encoder/decoder building blocks, the twins of ``unet_zoo_tpu.models.blocks``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from unet_zoo_tpu_torch import ops


# 3x3 conv + ReLU stages a block, as in the JAX package's DownBlock
DEPTH = 3


class DownBlock(nn.Module):
    """U-Net block: optional ceil-mode 2x2 avg-pool, then ``DEPTH`` he_normal
    conv+ReLU with no BatchNorm, run as one fused conv chain (``ops.ConvSeq``).

    ``x`` may be a tuple: the up path passes ``(upsampled, skip)``, which is
    concatenated in that order — upsampled channels first, as in the JAX
    model — before the chain. Only ``reversible_mode="plain"`` is ported.
    """

    def __init__(self, in_channels: int, features: int, pool: bool = True,
                 reversible_mode: str = "plain", dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if reversible_mode != "plain":
            raise NotImplementedError(f"reversible_mode={reversible_mode!r} is not ported yet")
        self.pool = pool
        self.convs = ops.ConvSeq(in_channels, features, DEPTH, dtype=dtype, device=device,
                                 generator=generator)

    def forward(self, x) -> torch.Tensor:
        if self.pool:
            if isinstance(x, (tuple, list)):
                raise ValueError("a pooling block takes one tensor")
            x = ops.avg_pool_ceil(x)
        return self.convs(x)


class PhiDownBlock(nn.Module):
    """PHiSeg block: optional ceil-mode 2x2 avg-pool, then ``DEPTH``
    torch_default conv + BatchNorm + ReLU (``ops.ConvSeq(norm=True)``, library
    ops). Only ``reversible_mode="plain"`` is ported."""

    def __init__(self, in_channels: int, features: int, pool: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool = pool
        self.convs = ops.ConvSeq(in_channels, features, DEPTH, norm=True, init_scheme="torch_default",
                                 dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool:
            x = ops.avg_pool_ceil(x)
        return self.convs(x)
