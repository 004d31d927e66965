"""Data pipeline of the PyTorch port: host-side batch providers over the
LIDC cache (``h5py`` imported only where HDF5 is read or written) and the
on-device 2D augmentation."""

from unet_zoo_tpu_torch.data import synthetic
from unet_zoo_tpu_torch.data.augment import (
    AugmentOptions,
    AugmentParams,
    augment_batch_2d,
    sample_augment_params,
    warp_batch_2d,
)
from unet_zoo_tpu_torch.data.batch_provider import BatchProvider, normalise_images, resize_batch
from unet_zoo_tpu_torch.data.lidc import LIDCData
from unet_zoo_tpu_torch.data.registry import DATASETS, data_switch

__all__ = [
    "AugmentOptions",
    "AugmentParams",
    "augment_batch_2d",
    "sample_augment_params",
    "warp_batch_2d",
    "BatchProvider",
    "normalise_images",
    "resize_batch",
    "LIDCData",
    "DATASETS",
    "data_switch",
    "synthetic",
]
