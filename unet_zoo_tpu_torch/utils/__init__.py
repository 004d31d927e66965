"""Utilities of the PyTorch port: the metrics writer, NIfTI I/O and the
BraTS export's post-processing."""

from unet_zoo_tpu_torch.utils.nii import load_nii, save_nii
from unet_zoo_tpu_torch.utils.postprocess import convert_to_onehot, keep_largest_connected_components
from unet_zoo_tpu_torch.utils.summary import MetricsWriter

__all__ = ["MetricsWriter", "convert_to_onehot", "keep_largest_connected_components", "load_nii", "save_nii"]
