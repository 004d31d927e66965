"""Evaluation metrics of the PyTorch port, on the device: GED (one Gram
product a label), variance-NCC and Dice. The BraTS metrics are not ported
yet (ROADMAP, queue A item 9)."""

from unet_zoo_tpu_torch.metrics.dice import dice_binary, dice_per_label
from unet_zoo_tpu_torch.metrics.ged import (
    generalised_energy_distance,
    pairwise_intersections,
    pairwise_iou_distance,
)
from unet_zoo_tpu_torch.metrics.ncc import ncc, variance_ncc_dist, variance_ncc_dist_class_first

__all__ = [
    "dice_binary",
    "dice_per_label",
    "generalised_energy_distance",
    "pairwise_intersections",
    "pairwise_iou_distance",
    "ncc",
    "variance_ncc_dist",
    "variance_ncc_dist_class_first",
]
