"""Model families of the PyTorch port. Only the U-Net is ported so far."""

from unet_zoo_tpu_torch.models.unet import UNet
from unet_zoo_tpu_torch.models.registry import get_model, MODELS

__all__ = ["UNet", "get_model", "MODELS"]
