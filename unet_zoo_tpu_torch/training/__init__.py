"""Training harness of the PyTorch port: the train step, the train loop,
validation and the test sweep with GED, variance-NCC and Dice, and
full-state checkpoints."""

from unet_zoo_tpu_torch.training.schedule import PlateauState, plateau_init, plateau_update
from unet_zoo_tpu_torch.training.state import TrainState, restore_checkpoint, save_checkpoint
from unet_zoo_tpu_torch.training.trainer import Trainer, adam_coupled_l2, image_metrics

__all__ = [
    "PlateauState",
    "plateau_init",
    "plateau_update",
    "TrainState",
    "restore_checkpoint",
    "save_checkpoint",
    "Trainer",
    "adam_coupled_l2",
    "image_metrics",
]
