"""Convolution blocks, the twins of ``unet_zoo_tpu.ops.conv`` (2D, NHWC).

* ``Conv``      — bare conv with bias, the torch padding rule (k=3 -> 1,
                  else 0) and a selectable init scheme; a tuple input is an
                  implicit channel concat.
* ``ConvBNAct`` — the parameter container of one conv + ReLU (the JAX
                  module's ``conv`` scope); BatchNorm is not ported yet.
* ``ConvSeq``   — ``depth`` stacked ``ConvBNAct`` without norm, run as the
                  fused conv-chain kernel.

Parameters are float32 and OIHW (``nn.Conv2d`` layout) and are drawn on the
CPU from an explicit ``torch.Generator`` (so a seed gives the same weights
on every device), then moved to ``device``. ``dtype`` is the compute dtype,
as in the JAX package: operands are cast to it, the bias is added in f32 and
the result is cast back to it (``conv_chain.conv2d_nhwc``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from unet_zoo_tpu_torch.ops import init as init_lib
from unet_zoo_tpu_torch.ops.pallas.conv_chain import conv2d_nhwc, fused_conv_chain, pack_kernel

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _concat(x: Tensors) -> torch.Tensor:
    return torch.cat(list(x), dim=-1) if isinstance(x, (tuple, list)) else x


class Conv(nn.Module):
    """Bare 2D convolution with bias over NHWC input, torch padding rule and init.

    ``init_scheme`` is 'he_normal', 'orthogonal' or 'torch_default'. ``x``
    may be a tuple of tensors, concatenated along channels in order (the
    JAX package splits the kernel instead; the result is the same).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 init_scheme: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding = kernel_size // 2 if kernel_size == 3 else 0
        self.dtype = dtype
        shape = (features, in_channels, kernel_size, kernel_size)
        kernel_init, bias_init = init_lib.SCHEMES[init_scheme]
        if bias_init is None:
            bias_init = init_lib.torch_default_conv_bias(math.prod(shape[1:]))
        self.weight = nn.Parameter(kernel_init(shape, generator).to(device))
        self.bias = nn.Parameter(bias_init((features,), generator).to(device))

    def forward(self, x: Tensors) -> torch.Tensor:
        x = _concat(x)
        return conv2d_nhwc(x.to(self.dtype or x.dtype), self.weight, self.bias, self.padding)


class ConvBNAct(nn.Module):
    """Parameters of one 3x3 he_normal conv followed by ReLU, at the JAX
    module's path (``conv``). ``ConvSeq`` runs the forward."""

    def __init__(self, in_channels: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(in_channels, features, init_scheme="he_normal",
                         device=device, generator=generator)


class ConvSeq(nn.Module):
    """``depth`` stacked 3x3 conv + ReLU without norm (``conv{i}.conv``
    parameter paths, as in the JAX package), run as one fused conv chain:
    the kernel of ``ops/pallas/conv_chain.py`` on CUDA, its plain version on
    the CPU. Gradients reach the float32 ``weight``/``bias`` parameters on
    both (``FusedConvChain`` on CUDA).

    The CUDA path packs the kernels into the kernel's weight layout in
    buffers allocated once per (dtype, device) and refilled on every
    forward, one copy per stage. A cache keyed on the parameters' ``_version``
    would go stale: ``torch.optim.Adam(fused=True)`` updates them in place
    without bumping it."""

    def __init__(self, in_channels: int, features: int, depth: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.dtype = dtype
        for i in range(depth):
            self.add_module(f"conv{i}", ConvBNAct(
                in_channels if i == 0 else features, features, device=device, generator=generator,
            ))
        self._packed: Dict[tuple, List[torch.Tensor]] = {}

    def _packed_kernels(self, weights: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        key = (dtype, weights[0].device)
        self._packed[key] = [pack_kernel(w, dtype, out) for w, out in
                             zip(weights, self._packed.get(key, [None] * len(weights)))]
        return self._packed[key]

    def forward(self, x: Tensors) -> torch.Tensor:
        x = _concat(x)
        x = x.to(self.dtype or x.dtype).contiguous()
        convs = [m.conv for m in self.children()]
        weights = [c.weight for c in convs]
        packed = self._packed_kernels(weights, x.dtype) if x.is_cuda else None
        return fused_conv_chain(x, weights, [c.bias for c in convs], packed=packed)
