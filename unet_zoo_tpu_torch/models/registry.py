"""Model registry, the twin of ``unet_zoo_tpu.models.registry``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from unet_zoo_tpu_torch.models.phiseg import REV_DEPTHS_3D, PHiSeg
from unet_zoo_tpu_torch.models.prob_unet import ProbUNet
from unet_zoo_tpu_torch.models.unet import UNet


def _phiseg3d(**kw) -> PHiSeg:
    """PHiSeg3D: the same class on NDHWC input, with one coupling block a
    reversible sequence (``REV_DEPTHS_3D``) unless ``rev_depths`` says otherwise."""
    kw.setdefault("rev_depths", REV_DEPTHS_3D)
    return PHiSeg(**kw)


MODELS: Dict[str, Any] = {"unet": UNet, "prob_unet": ProbUNet, "phiseg": PHiSeg, "phiseg3d": _phiseg3d}


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
    raise ValueError(f"unknown model '{name}'; available: {sorted(MODELS)}")
