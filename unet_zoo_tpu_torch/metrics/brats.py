"""BraTS metrics, the twin of ``unet_zoo_tpu.metrics.brats`` (the
reference's ``data/bratsUtils.py``).

Soft Dice, the 3-region (WT/TC/ET) Dice loss, sensitivity and specificity
on device tensors; ``hd95``, the 95th-percentile symmetric surface
distance, on the host with numpy and ``scipy.ndimage``'s exact Euclidean
distance transform, a copy of the JAX package's (an eval-only scalar a
volume, as the reference computed it on the CPU with medpy).
"""

from __future__ import annotations

import numpy as np
import torch


def soft_dice(pred: torch.Tensor, target: torch.Tensor, smoothing: float = 1.0,
              non_squared: bool = False) -> torch.Tensor:
    """Mean-over-batch soft Dice of (B, *spatial) floats. ``non_squared``
    sums the union over the whole batch, as the reference's branch does."""
    axes = tuple(range(1, pred.ndim))
    inter = (pred * target).sum(axes)
    if non_squared:
        union = pred.sum() + target.sum()
    else:
        union = (pred * pred).sum(axes) + (target * target).sum(axes)
    dice = (2 * inter + smoothing) / (union + smoothing)
    return torch.nan_to_num(dice, nan=1.0).mean()


def brats_dice_loss(outputs: torch.Tensor, labels: torch.Tensor, non_squared: bool = False) -> torch.Tensor:
    """3-region Dice loss over channel-last (B, *S, 3) WT/TC/ET maps, with
    the reference's /5 normalisation."""
    total = 0.0
    for c in range(3):
        total = total + (1.0 - soft_dice(outputs[..., c], labels[..., c], non_squared=non_squared))
    return total / 5.0


def sensitivity(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|pred > 0.5 and target| / |target|, 1 where the target is empty."""
    pred_bin = (pred > 0.5).float()
    target = target.float()
    inter = (pred_bin * target).sum()
    pos = target.sum()
    return torch.where(pos == 0, 1.0, inter / torch.clamp(pos, min=1.0))


def specificity(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """|pred <= 0.5 and not target| / |not target|."""
    pred_neg = (pred <= 0.5).float()
    target_neg = (target == 0).float()
    inter = (pred_neg * target_neg).sum()
    return inter / torch.clamp(target_neg.sum(), min=1.0)


def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from the surface voxels of ``a`` to the surface of ``b``
    (medpy's ``__surface_distances``, isotropic unit spacing)."""
    from scipy import ndimage

    a = a.astype(bool)
    b = b.astype(bool)
    conn = ndimage.generate_binary_structure(a.ndim, 1)
    a_border = a ^ ndimage.binary_erosion(a, structure=conn, iterations=1)
    b_border = b ^ ndimage.binary_erosion(b, structure=conn, iterations=1)
    dt = ndimage.distance_transform_edt(~b_border)
    return dt[a_border]


def hd95(pred: np.ndarray, target: np.ndarray) -> float:
    """95th-percentile symmetric Hausdorff distance of two host masks; -1
    when either is empty (the reference's ``getHd95`` edge case)."""
    pred = np.asarray(pred) > 0.5
    target = np.asarray(target) > 0.5
    if pred.sum() == 0 or target.sum() == 0:
        return -1.0
    d1 = _surface_distances(pred, target)
    d2 = _surface_distances(target, pred)
    return float(np.percentile(np.hstack([d1, d2]), 95))
