"""Data pipeline of the PyTorch port: on-device 2D augmentation so far."""

from unet_zoo_tpu_torch.data.augment import (
    AugmentOptions,
    AugmentParams,
    augment_batch_2d,
    sample_augment_params,
    warp_batch_2d,
)

__all__ = [
    "AugmentOptions",
    "AugmentParams",
    "augment_batch_2d",
    "sample_augment_params",
    "warp_batch_2d",
]
