"""Model families of the PyTorch port: the U-Net, ProbUNet, PHiSeg and PHiSeg3D."""

from unet_zoo_tpu_torch.models.phiseg import PHiSeg
from unet_zoo_tpu_torch.models.prob_unet import ProbUNet
from unet_zoo_tpu_torch.models.unet import UNet
from unet_zoo_tpu_torch.models.registry import get_model, MODELS

__all__ = ["PHiSeg", "ProbUNet", "UNet", "get_model", "MODELS"]
