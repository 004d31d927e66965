"""Model registry, the twin of ``unet_zoo_tpu.models.registry``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from unet_zoo_tpu_torch.models.phiseg import PHiSeg
from unet_zoo_tpu_torch.models.unet import UNet

MODELS: Dict[str, Any] = {"unet": UNet, "phiseg": PHiSeg}

# in the JAX package's registry, not ported yet
NOT_PORTED = ("prob_unet", "phiseg3d")


def resolve_device(device=None) -> torch.device:
    """The entry points' device: ``device`` as given, else the CUDA card.
    Raises where the card is asked for and there is none, rather than
    running on the CPU; the CPU is taken only when asked for by name."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on a CUDA card by default and torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return device


def get_model(name: str, **kwargs):
    """Builds model ``name`` on ``kwargs['device']``, by default the card."""
    if name in MODELS:
        return MODELS[name](**{**kwargs, "device": resolve_device(kwargs.get("device"))})
    if name in NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported to PyTorch yet; ported: {sorted(MODELS)}")
    raise ValueError(f"unknown model '{name}'; available: {sorted(MODELS)}")
