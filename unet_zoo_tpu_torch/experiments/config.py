"""Experiment configuration, a jax-free copy of ``unet_zoo_tpu.experiments.config``.

Only the fields the U-Net and PHiSeg 2D train steps read are carried over,
with the JAX package's names and defaults; the other families' fields come
back with their ports. ``validate`` raises on what the JAX package rejects
and on what the port does not run yet (ProbUNet, 3D, the remat and
reversible memory modes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from unet_zoo_tpu_torch.data.augment import AugmentOptions

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    experiment_name: str
    model: str = "phiseg"

    # architecture
    filter_channels: Tuple[int, ...] = (32, 64, 128, 192, 192, 192, 192)
    latent_levels: int = 5
    zdim: int = 2  # phiseg latent channels a level
    n_classes: int = 2
    input_channels: int = 1
    image_size: Tuple[int, ...] = (128, 128)  # spatial dims
    use_reversible: bool = False
    reversible_mode: Optional[str] = None  # overrides use_reversible: "reversible" | "remat" | "plain"
    exponential_weighting: bool = True
    kl_parity: bool = True  # the reference's sigma1 * sigma0 KL quirk
    dtype: str = "float32"  # compute dtype; parameters stay float32

    # data
    augmentation_options: Optional[AugmentOptions] = None  # augmented on the device

    # optimization
    batch_size: int = 12
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    min_lr: float = 1e-4
    lr_plateau_patience: int = 50_000
    lr_plateau_factor: float = 0.1
    seed: int = 0

    @property
    def effective_reversible_mode(self) -> str:
        if self.reversible_mode is not None:
            return self.reversible_mode
        return "reversible" if self.use_reversible else "plain"

    def model_kwargs(self) -> dict:
        """Constructor kwargs for ``unet_zoo_tpu_torch.models.registry.get_model``."""
        kw = dict(
            num_classes=self.n_classes,
            num_filters=tuple(self.filter_channels),
            in_channels=self.input_channels,
            dtype=_DTYPES[self.dtype],
        )
        if self.model == "phiseg":
            kw.update(
                latent_levels=self.latent_levels,
                zdim=self.zdim,
                image_size=tuple(self.image_size),
                exponential_weighting=self.exponential_weighting,
                kl_parity=self.kl_parity,
            )
        return kw

    def validate(self) -> None:
        if self.model not in ("unet", "prob_unet", "phiseg", "phiseg3d"):
            raise ValueError(f"unknown model '{self.model}'")
        if self.model not in ("unet", "phiseg"):
            raise NotImplementedError(f"model '{self.model}' is not ported to PyTorch yet")
        if self.effective_reversible_mode != "plain":
            raise NotImplementedError(f"reversible_mode '{self.effective_reversible_mode}' is not ported yet")
        if self.model == "phiseg" and not 1 <= self.latent_levels <= len(self.filter_channels):
            raise ValueError(f"latent_levels {self.latent_levels} must be in [1, {len(self.filter_channels)}]")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got '{self.dtype}'")
        if len(self.image_size) != 2:
            raise NotImplementedError("3D experiments are not ported to PyTorch yet")
        # pooling is ceil-mode and every upsample resizes to the skip's exact
        # shape, so any size works down to a non-empty coarsest level
        levels = len(self.filter_channels)
        for s in self.image_size:
            if s < 2 ** (levels - 1):
                raise ValueError(f"image size {s} too small for {levels} resolution levels")
