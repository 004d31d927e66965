"""Weight initializers, the PyTorch twins of ``unet_zoo_tpu.ops.init``.

Three schemes, as in the JAX package:

* ``he_normal``: Kaiming-normal kernel (fan_in, relu gain) plus a truncated
  normal bias (std 1e-3, clipped at 2 std);
* ``orthogonal``: orthogonal kernel plus the same bias;
* ``torch_default``: ``nn.Conv2d``'s own default, U(±1/sqrt(fan_in)) for
  kernel and bias.

Kernels here are OIHW (``nn.Conv2d`` layout); fan_in = prod(kernel spatial)
* in_channels, the same number the JAX package computes from HWIO. Every
initializer draws from an explicit ``torch.Generator`` and returns a new
float32 tensor on the CPU. Draws differ from JAX's for the same seed: the
tests compare distributions, not bits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Init = Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]


def _fan_in(shape) -> int:
    # OIHW: everything but the leading out-channel dim multiplies into fan_in
    return math.prod(shape[1:])


def kaiming_normal_fan_in(shape, generator: torch.Generator) -> torch.Tensor:
    """He-normal, fan_in mode, relu gain: std = sqrt(2 / fan_in)."""
    std = math.sqrt(2.0 / _fan_in(shape))
    return std * torch.randn(shape, generator=generator)


def truncated_normal_std(std: float = 1e-3) -> Init:
    """Normal with the given std, truncated at ±2 std."""

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return std * t

    return init


def torch_default_conv_kernel(shape, generator: torch.Generator) -> torch.Tensor:
    """nn.ConvNd default: kaiming_uniform(a=sqrt(5)) == U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(shape))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def torch_default_conv_bias(fan_in: int) -> Init:
    """nn.ConvNd default bias: U(±1/sqrt(fan_in)) with the *kernel's* fan_in."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(shape, generator: torch.Generator) -> torch.Tensor:
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    return init


def orthogonal_kernel(shape, generator: torch.Generator) -> torch.Tensor:
    """Orthogonal init over the (out, fan_in) matricization, torch semantics."""
    flat = torch.empty(shape[0], _fan_in(shape))
    torch.nn.init.orthogonal_(flat, generator=generator)
    return flat.reshape(shape)


# Named schemes: (kernel init, bias init or None for the torch default bias,
# which needs the kernel's fan_in and is built per layer)
SCHEMES: Dict[str, Tuple[Init, Optional[Init]]] = {
    "he_normal": (kaiming_normal_fan_in, truncated_normal_std(1e-3)),
    "orthogonal": (orthogonal_kernel, truncated_normal_std(1e-3)),
    "torch_default": (torch_default_conv_kernel, None),
}
