"""Built-in experiments, a jax-free copy of ``unet_zoo_tpu.experiments.registry``.

The ``unet`` and ``reversible_unet`` entries, ``prob_unet`` and
``prob_unet_reversible``, and the 2D LIDC PHiSeg entries, plain and
reversible, are ported (each with the JAX entry's values of the fields the
port carries); the JAX package's other names (UZH prostate, BraTS) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
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
        latent_levels=3,
        n_classes=2,  # reference file says 1 but its own loss needs >= 2
        batch_size=12,
        image_size=(128, 128),
        augmentation_options=_LIDC_AUG,
    )


def _reversible_unet() -> ExperimentConfig:
    return dataclasses.replace(_unet(), experiment_name="ReversibleUnet", use_reversible=True)


def _prob_unet() -> ExperimentConfig:
    """reference models/experiments/prob_unet.py"""
    return ExperimentConfig(
        experiment_name="ProbabilisticUnet",
        model="prob_unet",
        filter_channels=(32, 64, 128, 192, 192, 192, 192),
        latent_levels=1,
        latent_dim=6,
        no_convs_fcomb=3,
        n_classes=2,
        batch_size=12,
        image_size=(128, 128),
        augmentation_options=_LIDC_AUG,
    )


def _prob_unet_reversible() -> ExperimentConfig:
    return dataclasses.replace(_prob_unet(), experiment_name="ProbabilisticUnetRev", use_reversible=True)


def _phiseg_lidc(batch_size: int, reversible: bool = False) -> ExperimentConfig:
    """reference models/experiments/phiseg_[rev_]7_5_<bs>.py"""
    return ExperimentConfig(
        experiment_name=f"PHISeg{'Rev' if reversible else ''}_7_5_{batch_size}",
        model="phiseg",
        filter_channels=(32, 64, 128, 192, 192, 192, 192),
        latent_levels=5,
        n_classes=2,
        use_reversible=reversible,
        batch_size=batch_size,
        image_size=(128, 128),
        augmentation_options=_LIDC_AUG,
    )


def _phiseg_big() -> ExperimentConfig:
    """reference models/experiments/phiseg_big.py (256-wide, batch 32)"""
    return ExperimentConfig(
        experiment_name="PHISegBig",
        model="phiseg",
        filter_channels=(32, 64, 128, 192, 256, 256, 256),
        latent_levels=5,
        batch_size=32,
        image_size=(128, 128),
        augmentation_options=_LIDC_AUG,
    )


def _phiseg_big_reversible() -> ExperimentConfig:
    return dataclasses.replace(_phiseg_big(), experiment_name="PHISegBigRev", use_reversible=True)


EXPERIMENTS: Dict[str, Callable[[], ExperimentConfig]] = {
    "unet": _unet,
    "reversible_unet": _reversible_unet,
    "prob_unet": _prob_unet,
    "prob_unet_reversible": _prob_unet_reversible,
    **{f"phiseg_7_5_{bs}": (lambda b: lambda: _phiseg_lidc(b))(bs) for bs in (12, 24, 36, 48, 56)},
    **{f"phiseg_rev_7_5_{bs}": (lambda b: lambda: _phiseg_lidc(b, True))(bs) for bs in (12, 24, 36, 48, 56, 60, 64)},
    "phiseg_big": _phiseg_big,
    "phiseg_big_reversible": _phiseg_big_reversible,
}

# in the JAX package's registry, not ported yet
NOT_PORTED = (
    *(f"phiseg_uzh_7_5_{res}" for res in (192, 256, 384, 512)),
    *(f"phiseg_uzh_rev_7_5_{res}" for res in (192, 224, 256, 384, 512)),
    "phiseg_brats",
)


def get_experiment(name: str) -> ExperimentConfig:
    if name in EXPERIMENTS:
        cfg = EXPERIMENTS[name]()
        cfg.validate()
        return cfg
    if name in NOT_PORTED:
        raise NotImplementedError(f"experiment '{name}' is not ported to PyTorch yet; ported: {sorted(EXPERIMENTS)}")
    raise ValueError(f"unknown experiment '{name}'; available: {sorted(EXPERIMENTS)}")
