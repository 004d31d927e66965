"""Encoder/decoder building blocks, the twins of ``unet_zoo_tpu.models.blocks``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from unet_zoo_tpu_torch import ops


# 3x3 conv + ReLU stages a block, as in the JAX package's DownBlock
DEPTH = 3


def seq_name(mode: str) -> str:
    """The JAX module's name of a block's sequence: ``rev`` for a reversible
    one, ``convs`` for plain and remat (one parameter tree)."""
    return "rev" if mode == "reversible" else "convs"


class DownBlock(nn.Module):
    """U-Net block: optional ceil-mode 2x2 avg-pool, then ``DEPTH`` he_normal
    conv+ReLU with no BatchNorm, run as one fused conv chain (``ops.ConvSeq``)
    in ``reversible_mode`` "plain" and "remat" (``convs``); in "reversible" a
    ``ReversibleSequence`` of ``DEPTH`` he_normal coupling blocks with
    BatchNorm (``rev``), as in the JAX model.

    ``x`` may be a tuple: the up path passes ``(upsampled, skip)``, which is
    concatenated in that order — upsampled channels first, as in the JAX
    model — before the chain.
    """

    def __init__(self, in_channels: int, features: int, pool: bool = True,
                 reversible_mode: str = "plain", dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool = pool
        self.seq_name = seq_name(reversible_mode)
        self.add_module(self.seq_name, ops.conv_sequence(
            in_channels, features, DEPTH, mode=reversible_mode, norm=False, init_scheme="he_normal", dtype=dtype,
            device=device, generator=generator))

    def forward(self, x) -> torch.Tensor:
        if self.pool:
            if isinstance(x, (tuple, list)):
                raise ValueError("a pooling block takes one tensor")
            x = ops.avg_pool_ceil(x)
        return getattr(self, self.seq_name)(x)


class PhiDownBlock(nn.Module):
    """PHiSeg block: optional ceil-mode 2x2(x2) avg-pool, then ``DEPTH``
    torch_default conv + BatchNorm + ReLU (``ops.ConvSeq(norm=True)``,
    library ops) in "plain" and "remat", or ``rev_depth`` coupling blocks in
    "reversible"; over ``ndim`` spatial axes."""

    def __init__(self, in_channels: int, features: int, pool: bool = True, reversible_mode: str = "plain",
                 rev_depth: int = 3, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None, ndim: int = 2):
        super().__init__()
        self.pool = pool
        self.seq_name = seq_name(reversible_mode)
        self.add_module(self.seq_name, ops.conv_sequence(
            in_channels, features, DEPTH, mode=reversible_mode, rev_depth=rev_depth, norm=True,
            init_scheme="torch_default", dtype=dtype, device=device, generator=generator, ndim=ndim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool:
            x = ops.avg_pool_ceil(x)
        return getattr(self, self.seq_name)(x)
