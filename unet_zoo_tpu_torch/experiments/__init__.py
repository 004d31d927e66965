"""Experiment and system configuration of the PyTorch port, and the registry
of the ported experiments."""

from unet_zoo_tpu_torch.experiments.config import ExperimentConfig, SystemConfig, load_experiment
from unet_zoo_tpu_torch.experiments.registry import get_experiment

__all__ = ["ExperimentConfig", "SystemConfig", "get_experiment", "load_experiment"]
