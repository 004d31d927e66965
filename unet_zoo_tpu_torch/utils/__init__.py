"""Utilities of the PyTorch port: the metrics writer, NIfTI I/O, the BraTS
export's post-processing, the PNG writer and the profiling helpers."""

from unet_zoo_tpu_torch.utils.nii import load_nii, save_nii
from unet_zoo_tpu_torch.utils.png import read_png, write_png
from unet_zoo_tpu_torch.utils.postprocess import convert_to_onehot, keep_largest_connected_components
from unet_zoo_tpu_torch.utils.profiling import device_memory_stats, step_memory_analysis, trace
from unet_zoo_tpu_torch.utils.summary import MetricsWriter

__all__ = ["MetricsWriter", "convert_to_onehot", "device_memory_stats", "keep_largest_connected_components",
           "load_nii", "read_png", "save_nii", "step_memory_analysis", "trace", "write_png"]
