"""Dataset registry, the twin of ``unet_zoo_tpu.data.registry``: names ->
data classes. LIDC and BraTS are ported; the JAX package's UZH datasets
raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Any, Dict

from unet_zoo_tpu_torch.data.brats import BratsData
from unet_zoo_tpu_torch.data.lidc import LIDCData

DATASETS: Dict[str, Any] = {"lidc": LIDCData, "brats": BratsData}

# in the JAX package's registry, not ported yet
NOT_PORTED = ("uzh_prostate", "uzh_mat")


def data_switch(name: str):
    if name in DATASETS:
        return DATASETS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"dataset '{name}' is not ported to PyTorch yet; ported: {sorted(DATASETS)}")
    raise ValueError(f"unknown dataset '{name}'; available: {sorted(DATASETS)}")
