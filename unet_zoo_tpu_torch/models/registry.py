"""Model registry, the twin of ``unet_zoo_tpu.models.registry``."""

from __future__ import annotations

from typing import Any, Dict

from unet_zoo_tpu_torch.models.unet import UNet

MODELS: Dict[str, Any] = {"unet": UNet}

# in the JAX package's registry, not ported yet
NOT_PORTED = ("prob_unet", "phiseg", "phiseg3d")


def get_model(name: str, **kwargs):
    if name in MODELS:
        return MODELS[name](**kwargs)
    if name in NOT_PORTED:
        raise NotImplementedError(f"model '{name}' is not ported to PyTorch yet; ported: {sorted(MODELS)}")
    raise ValueError(f"unknown model '{name}'; available: {sorted(MODELS)}")
