"""Experiment configuration of the PyTorch port (the ``unet`` entry so far)."""

from unet_zoo_tpu_torch.experiments.config import ExperimentConfig
from unet_zoo_tpu_torch.experiments.registry import get_experiment

__all__ = ["ExperimentConfig", "get_experiment"]
