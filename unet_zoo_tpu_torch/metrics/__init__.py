"""Evaluation metrics of the PyTorch port, on the device: GED (one Gram
product a label), variance-NCC and Dice; and BraTS's soft Dice,
sensitivity and specificity, with HD95 on the host."""

from unet_zoo_tpu_torch.metrics.brats import brats_dice_loss, hd95, sensitivity, soft_dice, specificity
from unet_zoo_tpu_torch.metrics.dice import dice_binary, dice_per_label
from unet_zoo_tpu_torch.metrics.ged import (
    generalised_energy_distance,
    pairwise_intersections,
    pairwise_iou_distance,
)
from unet_zoo_tpu_torch.metrics.ncc import ncc, variance_ncc_dist, variance_ncc_dist_class_first

__all__ = [
    "brats_dice_loss",
    "hd95",
    "sensitivity",
    "soft_dice",
    "specificity",
    "dice_binary",
    "dice_per_label",
    "generalised_energy_distance",
    "pairwise_intersections",
    "pairwise_iou_distance",
    "ncc",
    "variance_ncc_dist",
    "variance_ncc_dist_class_first",
]
