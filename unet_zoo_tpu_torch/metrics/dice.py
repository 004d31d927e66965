"""Dice coefficients, the twin of ``unet_zoo_tpu.metrics.dice``, with the
reference's empty-mask conventions: both masks empty gives 1, exactly one
empty gives 0, otherwise 2|A∩B| / (|A| + |B|).
"""

from __future__ import annotations

import torch


def dice_binary(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Dice of two binary masks of any shape, a float32 scalar."""
    pred = pred.float().reshape(-1)
    gt = gt.float().reshape(-1)
    sp, sg = pred.sum(), gt.sum()
    inter = (pred * gt).sum()
    both_empty = (sp == 0) & (sg == 0)
    one_empty = ((sp == 0) | (sg == 0)) & ~both_empty
    dice = 2.0 * inter / torch.clamp(sp + sg, min=1.0)
    return torch.where(both_empty, 1.0, torch.where(one_empty, 0.0, dice))


def dice_per_label(pred_labels: torch.Tensor, gt_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class Dice between integer label maps: (num_classes,)."""
    return torch.stack([dice_binary(pred_labels == lbl, gt_labels == lbl) for lbl in range(num_classes)])
