"""Op library of the PyTorch port: conv blocks in the three memory modes,
BatchNorm, pooling, resizing, initializers. NHWC or NDHWC at every public
function, as in ``unet_zoo_tpu.ops``."""

from unet_zoo_tpu_torch.ops.init import (
    kaiming_normal_fan_in,
    truncated_normal_std,
    torch_default_conv_kernel,
    torch_default_conv_bias,
    orthogonal_kernel,
)
from unet_zoo_tpu_torch.ops.conv import MEMORY_MODES, Conv, ConvBNAct, ConvSeq, conv_sequence, remat
from unet_zoo_tpu_torch.ops.norm import BatchNorm
from unet_zoo_tpu_torch.ops.pool import avg_pool_ceil
from unet_zoo_tpu_torch.ops.resize import resize_linear, upsample_nearest
from unet_zoo_tpu_torch.ops.reversible import ReversibleChain, ReversibleSequence

__all__ = [
    "kaiming_normal_fan_in",
    "truncated_normal_std",
    "torch_default_conv_kernel",
    "torch_default_conv_bias",
    "orthogonal_kernel",
    "Conv",
    "ConvBNAct",
    "ConvSeq",
    "MEMORY_MODES",
    "conv_sequence",
    "remat",
    "ReversibleChain",
    "ReversibleSequence",
    "BatchNorm",
    "avg_pool_ceil",
    "resize_linear",
    "upsample_nearest",
]
