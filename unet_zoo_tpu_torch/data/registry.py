"""Dataset registry, the twin of ``unet_zoo_tpu.data.registry``: names ->
data classes."""

from __future__ import annotations

from typing import Any, Dict

from unet_zoo_tpu_torch.data.brats import BratsData
from unet_zoo_tpu_torch.data.lidc import LIDCData
from unet_zoo_tpu_torch.data.uzh import UZHMatData, UZHProstateData

DATASETS: Dict[str, Any] = {"lidc": LIDCData, "uzh_prostate": UZHProstateData, "uzh_mat": UZHMatData,
                            "brats": BratsData}


def data_switch(name: str):
    if name in DATASETS:
        return DATASETS[name]
    raise ValueError(f"unknown dataset '{name}'; available: {sorted(DATASETS)}")
