"""Hand-written CUDA kernels for the hot ops, at the paths of the JAX
package's Pallas kernels they replace (sources in ``unet_zoo_tpu_torch/csrc``).

`fused_conv_chain` — a chain of 3x3 conv + bias + ReLU stages, the U-Net
block (see conv_chain.py). The forward is the kernel; the backward
(``FusedConvChain``) takes the library's conv gradients, as the JAX package
takes XLA's.
"""

from unet_zoo_tpu_torch.ops.pallas.conv_chain import (
    fused_conv_chain,
    fused_conv_chain_reference,
)

__all__ = ["fused_conv_chain", "fused_conv_chain_reference"]
