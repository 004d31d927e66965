"""Experiment and system configuration, a jax-free copy of
``unet_zoo_tpu.experiments.config``.

``ExperimentConfig`` carries the fields that the U-Net, ProbUNet, PHiSeg and
PHiSeg3D train steps, the evaluation, the train loop and the LIDC, UZH and
BraTS loaders read, with the JAX package's names and defaults.
``validate`` raises on what the JAX package rejects and on what the port
does not run (a 3D U-Net or ProbUNet, whose BN-free conv chains have no 3D
kernel). ``SystemConfig`` is the JAX package's whole, so that one
``config.json`` loads in both packages. ``load_experiment`` takes a registry
name or a ``.py`` file that defines ``config``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Optional, Tuple, Union

import torch

from unet_zoo_tpu_torch.data.augment import Augment3DOptions, AugmentOptions
from unet_zoo_tpu_torch.ops.conv import MEMORY_MODES

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Machine paths."""

    project_root: str = "."
    log_root: str = "logs"
    data_root: str = "data/data_lidc.pickle"
    preproc_folder: str = "preproc"
    uzh_input_image_folder: str = ""
    uzh_input_mask_folder: str = ""
    uzh_preproc_folder: str = "preproc"
    brats_root: str = ""
    # read by the JAX package only (its XLA compilation cache); kept so
    # that the same config.json loads here
    jax_compilation_cache_dir: Optional[str] = "~/.cache/unet_zoo_tpu/jax"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    experiment_name: str
    log_dir_name: str = "lidc"
    model: str = "phiseg"
    data_loader: str = "lidc"  # a data.registry name

    # architecture
    filter_channels: Tuple[int, ...] = (32, 64, 128, 192, 192, 192, 192)
    latent_levels: int = 5
    latent_dim: int = 6  # prob_unet only
    zdim: int = 2  # phiseg latent channels a level
    no_convs_fcomb: int = 4  # prob_unet only
    n_classes: int = 2
    input_channels: int = 1
    image_size: Tuple[int, ...] = (128, 128)  # spatial dims
    use_reversible: bool = False
    reversible_mode: Optional[str] = None  # overrides use_reversible: "reversible" | "remat" | "plain"
    exponential_weighting: bool = True
    kl_parity: bool = True  # the reference's sigma1 * sigma0 KL quirk
    dtype: str = "float32"  # compute dtype; parameters stay float32

    # data
    num_labels_per_subject: int = 4
    annotator_range: Optional[Tuple[int, ...]] = None
    resize_to: Optional[Tuple[int, ...]] = None
    target_resolution: Optional[Tuple[float, ...]] = None  # UZH: the slices' pixel size after rescaling
    augmentation_options: Optional[AugmentOptions] = None
    augmentation_options_3d: Optional[Augment3DOptions] = None
    augment_on: str = "device"  # or "host": the cv2 chain on the host (data/augment_host.py)
    data_seed: Optional[int] = 0
    loader: str = "h5py"  # the standard provider over the cache; "native": the C++ batch store (native/store.py)

    # optimization
    iterations: int = 5_000_000
    batch_size: int = 12
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    min_lr: float = 1e-4
    lr_plateau_patience: int = 50_000
    lr_plateau_factor: float = 0.1

    # evaluation and logging
    validation_samples: int = 16
    num_validation_images: Union[int, str] = 100  # or "all"
    logging_frequency: int = 1000
    validation_frequency: int = 1000
    pretrained_model: Optional[str] = None  # a checkpoint's name in the log directory
    seed: int = 0

    @property
    def effective_reversible_mode(self) -> str:
        if self.reversible_mode is not None:
            return self.reversible_mode
        return "reversible" if self.use_reversible else "plain"

    @property
    def is_3d(self) -> bool:
        return len(self.image_size) == 3

    def model_kwargs(self) -> dict:
        """Constructor kwargs for ``unet_zoo_tpu_torch.models.registry.get_model``."""
        kw = dict(
            num_classes=self.n_classes,
            num_filters=tuple(self.filter_channels),
            in_channels=self.input_channels,
            reversible_mode=self.effective_reversible_mode,
            dtype=_DTYPES[self.dtype],
        )
        if self.model in ("phiseg", "phiseg3d"):
            kw.update(
                latent_levels=self.latent_levels,
                zdim=self.zdim,
                image_size=tuple(self.image_size),
                exponential_weighting=self.exponential_weighting,
                kl_parity=self.kl_parity,
            )
        elif self.model == "prob_unet":
            kw.update(latent_dim=self.latent_dim, no_convs_fcomb=self.no_convs_fcomb, kl_parity=self.kl_parity)
        return kw

    def validate(self) -> None:
        if self.model not in ("unet", "prob_unet", "phiseg", "phiseg3d"):
            raise ValueError(f"unknown model '{self.model}'")
        if self.effective_reversible_mode not in MEMORY_MODES:
            raise ValueError(f"reversible_mode must be one of {MEMORY_MODES}, got '{self.effective_reversible_mode}'")
        if self.model in ("phiseg", "phiseg3d") and not 1 <= self.latent_levels <= len(self.filter_channels):
            raise ValueError(f"latent_levels {self.latent_levels} must be in [1, {len(self.filter_channels)}]")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got '{self.dtype}'")
        if self.augment_on not in ("device", "host"):
            raise ValueError(f"augment_on must be 'device' or 'host', got '{self.augment_on}'")
        if self.loader not in ("h5py", "native"):
            raise ValueError(f"loader must be 'h5py' or 'native', got '{self.loader}'")
        if self.loader == "native" and self.resize_to is not None:
            raise ValueError("loader='native' serves raw records; resize_to needs the h5py provider's post-processing")
        if len(self.image_size) not in (2, 3):
            raise ValueError(f"image_size must have 2 or 3 axes, got {self.image_size}")
        if self.is_3d and self.model not in ("phiseg", "phiseg3d"):
            raise NotImplementedError(f"a 3D '{self.model}' is not ported: its BN-free conv chains have no 3D kernel")
        # pooling is ceil-mode and every upsample resizes to the skip's exact
        # shape, so any size works down to a non-empty coarsest level
        levels = len(self.filter_channels)
        for s in self.image_size:
            if s < 2 ** (levels - 1):
                raise ValueError(f"image size {s} too small for {levels} resolution levels")


def load_experiment(name_or_path: str) -> ExperimentConfig:
    """A registry name, or the path of a ``.py`` file that defines
    ``config = ExperimentConfig(...)``."""
    if os.path.exists(name_or_path) and name_or_path.endswith(".py"):
        spec = importlib.util.spec_from_file_location("exp_config", name_or_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        cfg = getattr(module, "config", None)
        if not isinstance(cfg, ExperimentConfig):
            raise TypeError(f"{name_or_path} must define config = unet_zoo_tpu_torch.experiments.ExperimentConfig(...)")
        return cfg
    from unet_zoo_tpu_torch.experiments.registry import get_experiment

    return get_experiment(name_or_path)
