"""Built-in experiments, a jax-free copy of ``unet_zoo_tpu.experiments.registry``.

Only the ``unet`` entry is ported; the JAX package's other names raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from unet_zoo_tpu_torch.data.augment import AugmentOptions
from unet_zoo_tpu_torch.experiments.config import ExperimentConfig

_LIDC_AUG = AugmentOptions(  # reference phiseg_7_5_12.py:33-37
    do_rotations=True,
    do_scaleaug=True,
    do_fliplr=True,
    do_flipud=True,
    nlabels=2,
)


def _unet() -> ExperimentConfig:
    """reference models/experiments/unet.py (4-level vanilla U-Net)"""
    return ExperimentConfig(
        experiment_name="Unet",
        model="unet",
        filter_channels=(32, 64, 128, 192),
        n_classes=2,  # reference file says 1 but its own loss needs >= 2
        image_size=(128, 128),
        augmentation_options=_LIDC_AUG,
    )


EXPERIMENTS: Dict[str, Callable[[], ExperimentConfig]] = {"unet": _unet}

# in the JAX package's registry, not ported yet
NOT_PORTED = (
    *(f"phiseg_7_5_{bs}" for bs in (12, 24, 36, 48, 56)),
    *(f"phiseg_rev_7_5_{bs}" for bs in (12, 24, 36, 48, 56, 60, 64)),
    "phiseg_big", "phiseg_big_reversible",
    *(f"phiseg_uzh_7_5_{res}" for res in (192, 256, 384, 512)),
    *(f"phiseg_uzh_rev_7_5_{res}" for res in (192, 224, 256, 384, 512)),
    "prob_unet", "prob_unet_reversible", "reversible_unet", "phiseg_brats",
)


def get_experiment(name: str) -> ExperimentConfig:
    if name in EXPERIMENTS:
        cfg = EXPERIMENTS[name]()
        cfg.validate()
        return cfg
    if name in NOT_PORTED:
        raise NotImplementedError(f"experiment '{name}' is not ported to PyTorch yet; ported: {sorted(EXPERIMENTS)}")
    raise ValueError(f"unknown experiment '{name}'; available: {sorted(EXPERIMENTS)}")
