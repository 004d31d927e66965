"""Data pipeline of the PyTorch port: host-side batch providers over the
LIDC, UZH prostate and BraTS caches (``cache``: HDF5 where ``h5py``
imports, else a directory of ``.npy`` files), the on-device 2D and 3D
augmentation, and the host (cv2) augmentation (``augment_host``, cv2
imported where it runs)."""

from unet_zoo_tpu_torch.data import synthetic
from unet_zoo_tpu_torch.data.augment import (
    Augment3DOptions,
    Augment3DParams,
    AugmentOptions,
    AugmentParams,
    augment_batch_2d,
    augment_batch_3d,
    sample_augment_3d_params,
    sample_augment_params,
    warp_batch_2d,
    warp_batch_3d,
)
from unet_zoo_tpu_torch.data.batch_provider import BatchProvider, normalise_images, resize_batch
from unet_zoo_tpu_torch.data.brats import BratsData
from unet_zoo_tpu_torch.data.lidc import LIDCData
from unet_zoo_tpu_torch.data.registry import DATASETS, data_switch
from unet_zoo_tpu_torch.data.uzh import UZHMatData, UZHProstateData

__all__ = [
    "Augment3DOptions",
    "Augment3DParams",
    "AugmentOptions",
    "AugmentParams",
    "augment_batch_2d",
    "augment_batch_3d",
    "sample_augment_3d_params",
    "sample_augment_params",
    "warp_batch_2d",
    "warp_batch_3d",
    "BratsData",
    "BatchProvider",
    "normalise_images",
    "resize_batch",
    "LIDCData",
    "UZHMatData",
    "UZHProstateData",
    "DATASETS",
    "data_switch",
    "synthetic",
]
