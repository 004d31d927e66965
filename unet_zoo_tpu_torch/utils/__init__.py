"""Utilities of the PyTorch port: the metrics writer."""

from unet_zoo_tpu_torch.utils.summary import MetricsWriter

__all__ = ["MetricsWriter"]
