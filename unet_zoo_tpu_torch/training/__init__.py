"""Training harness of the PyTorch port: the U-Net train step so far."""

from unet_zoo_tpu_torch.training.schedule import PlateauState, plateau_init, plateau_update
from unet_zoo_tpu_torch.training.state import TrainState, restore_checkpoint, save_checkpoint
from unet_zoo_tpu_torch.training.trainer import Trainer, adam_coupled_l2

__all__ = [
    "PlateauState",
    "plateau_init",
    "plateau_update",
    "TrainState",
    "restore_checkpoint",
    "save_checkpoint",
    "Trainer",
    "adam_coupled_l2",
]
