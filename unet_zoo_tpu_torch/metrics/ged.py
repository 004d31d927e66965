"""Generalised Energy Distance, the twin of ``unet_zoo_tpu.metrics.ged``.

The distance between two label maps is 1 - mean over ``label_range`` of
their IoU, with the empty-mask conventions (both empty: IoU 1; exactly one
empty: IoU 0). The mean divides by ``nlabels`` even where ``label_range``
is shorter, a quirk of the reference kept as it is (the harness passes
nlabels = n_classes - 1 and label_range = 1..n_classes-1, where the two
agree).

GED² = 2/(NM) Σ d(s_i, y_j) - 1/N² Σ d(s_i, s_j) - 1/M² Σ d(y_i, y_j).

All three blocks come from one Gram product a label over the stacked
(N + M, P) binary masks: intersections are ``A @ A.T``, unions follow from
the row sums. The product stays in float32, where the counts are exact
integers for P < 2^24, even under an enclosing autocast.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def pairwise_intersections(masks: torch.Tensor, label: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For integer label maps ``masks`` (K, *spatial): |m_i ∩ m_j| (K, K)
    and |m_i| (K,) of the pixels labelled ``label``, in float32."""
    binm = (masks.reshape(masks.shape[0], -1) == label).float()
    with torch.autocast(binm.device.type, enabled=False):
        inter = binm @ binm.T
    return inter, binm.sum(1)


def pairwise_iou_distance(masks: torch.Tensor, nlabels: int, label_range: Sequence[int]) -> torch.Tensor:
    """All-pairs distance d(m_i, m_j) of integer label maps (K, *spatial): (K, K) float32."""
    total = torch.zeros((masks.shape[0],) * 2, dtype=torch.float32, device=masks.device)
    for lbl in label_range:
        inter, sizes = pairwise_intersections(masks, lbl)
        union = sizes[:, None] + sizes[None, :] - inter
        empty_i, empty_j = sizes[:, None] == 0, sizes[None, :] == 0
        both_empty = empty_i & empty_j
        one_empty = (empty_i | empty_j) & ~both_empty
        iou = torch.where(both_empty, 1.0, torch.where(one_empty, 0.0, inter / torch.clamp(union, min=1.0)))
        total = total + iou
    return 1.0 - total / nlabels


def generalised_energy_distance(sample_arr: torch.Tensor, gt_arr: torch.Tensor, nlabels: int = 1,
                                label_range: Optional[Sequence[int]] = None) -> torch.Tensor:
    """sample_arr (N, *spatial) and gt_arr (M, *spatial) integer labels.
    Returns GED² as a float32 scalar (it can be negative on tiny inputs, as
    in the reference)."""
    if label_range is None:
        label_range = range(nlabels)
    n, m = sample_arr.shape[0], gt_arr.shape[0]
    stacked = torch.cat([sample_arr.reshape(n, -1), gt_arr.reshape(m, -1).to(sample_arr.dtype)])
    d = pairwise_iou_distance(stacked, nlabels, label_range)
    return (2.0 / (n * m)) * d[:n, n:].sum() - (1.0 / n ** 2) * d[:n, :n].sum() - (1.0 / m ** 2) * d[n:, n:].sum()
