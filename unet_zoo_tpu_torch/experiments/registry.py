"""Built-in experiments, a jax-free copy of ``unet_zoo_tpu.experiments.registry``.

Every JAX entry, each with the JAX entry's values of the fields the port
carries: ``unet`` and ``reversible_unet``, ``prob_unet`` and
``prob_unet_reversible``, the 2D LIDC and UZH prostate PHiSeg entries,
plain and reversible, and ``phiseg_brats`` (PHiSeg3D).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from unet_zoo_tpu_torch.data.augment import Augment3DOptions, AugmentOptions
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


def _phiseg_uzh(resolution: int, reversible: bool) -> ExperimentConfig:
    """reference models/experiments/phiseg_uzh_[rev_]7_5_<res>.py"""
    return ExperimentConfig(
        experiment_name=f"PHISegUZH{'Rev' if reversible else ''}_7_5_{resolution}",
        log_dir_name="uzh",
        model="phiseg",
        data_loader="uzh_prostate",
        filter_channels=(32, 64, 128, 192, 192, 192, 192),
        latent_levels=5,
        n_classes=3,
        num_labels_per_subject=6,
        use_reversible=reversible,
        batch_size=12,
        image_size=(resolution, resolution),
        resize_to=(resolution, resolution),
        target_resolution=(0.625, 0.625),
        augmentation_options=AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True,
                                            nlabels=3),
        validation_samples=16,
        num_validation_images="all",
    )


def _phiseg_brats() -> ExperimentConfig:
    """reference models/experiments/phiseg_brats.py (volumetric 128^3)"""
    return ExperimentConfig(
        experiment_name="PHISeg_brats",
        log_dir_name="brats",
        model="phiseg3d",
        data_loader="brats",
        filter_channels=(32, 64, 128),
        latent_levels=2,
        n_classes=3,
        num_labels_per_subject=1,
        use_reversible=True,
        input_channels=4,
        batch_size=1,
        image_size=(128, 128, 128),
        augmentation_options_3d=Augment3DOptions(
            do_rotate=True, rot_degrees=20.0,
            do_scale=True, scale_factor=1.1,
            do_elastic=True, elastic_sigma=10.0,
            do_flip=True, do_intensity_shift=True, max_intensity_shift=0.1,
            nlabels=3,
        ),
    )


EXPERIMENTS: Dict[str, Callable[[], ExperimentConfig]] = {
    "unet": _unet,
    "reversible_unet": _reversible_unet,
    "prob_unet": _prob_unet,
    "prob_unet_reversible": _prob_unet_reversible,
    **{f"phiseg_7_5_{bs}": (lambda b: lambda: _phiseg_lidc(b))(bs) for bs in (12, 24, 36, 48, 56)},
    **{f"phiseg_rev_7_5_{bs}": (lambda b: lambda: _phiseg_lidc(b, True))(bs) for bs in (12, 24, 36, 48, 56, 60, 64)},
    **{f"phiseg_uzh_7_5_{res}": (lambda r: lambda: _phiseg_uzh(r, False))(res) for res in (192, 256, 384, 512)},
    **{f"phiseg_uzh_rev_7_5_{res}": (lambda r: lambda: _phiseg_uzh(r, True))(res)
       for res in (192, 224, 256, 384, 512)},
    "phiseg_big": _phiseg_big,
    "phiseg_big_reversible": _phiseg_big_reversible,
    "phiseg_brats": _phiseg_brats,
}


def get_experiment(name: str) -> ExperimentConfig:
    if name in EXPERIMENTS:
        cfg = EXPERIMENTS[name]()
        cfg.validate()
        return cfg
    raise ValueError(f"unknown experiment '{name}'; available: {sorted(EXPERIMENTS)}")
