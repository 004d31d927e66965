"""The evaluation of one image's samples, the reference (UNet-Zoo's
``utils.generalised_energy_distance``, ``variance_ncc_dist`` and the Dice
of the mean prediction): logits (n, C, H, W), every grader's labels
(A, H, W) and the chosen grader's (H, W).

* GED^2 = 2/(nA) sum d(s, y) - 1/n^2 sum d(s, s') - 1/A^2 sum d(y, y'), d = 1 -
  the mean IoU over the foreground labels 1..C-1 (both masks empty: IoU 1;
  one empty: 0);
* variance-NCC: the mean over graders of the zero-normalised
  cross-correlation (population standard deviations) of E[CE(s, mean s)]
  and E[CE(s, y_j)], the log taking 1e-8;
* Dice per class of the argmax of the mean softmax against the chosen
  grader (both empty: 1; one empty: 0).
"""

from __future__ import annotations

from typing import Dict

import torch


def _distances(masks: torch.Tensor, classes: int) -> torch.Tensor:
    """d of every pair of integer maps (K, P)."""
    total = 0.0
    for lbl in range(1, classes):
        m = (masks == lbl).double()
        inter = m @ m.T
        size = m.sum(1)
        union = size[:, None] + size[None, :] - inter
        empty_a, empty_b = (size == 0)[:, None], (size == 0)[None, :]
        iou = torch.where(empty_a & empty_b, 1.0,
                          torch.where(empty_a | empty_b, 0.0, inter / union.clamp(min=1.0)))
        total = total + iou
    return 1.0 - total / (classes - 1)


def ged(pred: torch.Tensor, gts: torch.Tensor, classes: int) -> torch.Tensor:
    n, a = pred.shape[0], gts.shape[0]
    d = _distances(torch.cat([pred.reshape(n, -1), gts.reshape(a, -1).to(pred.dtype)]), classes)
    return 2.0 / (n * a) * d[:n, n:].sum() - d[:n, :n].sum() / n ** 2 - d[n:, n:].sum() / a ** 2


def _zncc(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    a, v = a.reshape(-1).double(), v.reshape(-1).double()
    a = (a - a.mean()) / (a.std(correction=0) * a.numel())
    v = (v - v.mean()) / v.std(correction=0)
    return (a * v).sum()


def variance_ncc(probs: torch.Tensor, gts: torch.Tensor, classes: int) -> torch.Tensor:
    """probs (n, C, H, W) softmax; gts (A, H, W) integer labels."""
    log_p = torch.log(probs + 1e-8)
    e_ss = -(probs.mean(0, keepdim=True) * log_p).sum(1).mean(0)
    scores = []
    for j in range(gts.shape[0]):
        onehot = torch.nn.functional.one_hot(gts[j].long(), classes).permute(2, 0, 1).float()
        e_sy = -(onehot[None] * log_p).sum(1).mean(0)
        scores.append(_zncc(e_ss, e_sy))
    return torch.stack(scores).mean()


def dice(pred: torch.Tensor, gt: torch.Tensor, classes: int) -> torch.Tensor:
    out = []
    for lbl in range(classes):
        a, b = (pred == lbl).double(), (gt == lbl).double()
        sa, sb = a.sum(), b.sum()
        if sa == 0 and sb == 0:
            out.append(torch.ones((), dtype=torch.float64, device=pred.device))
        elif sa == 0 or sb == 0:
            out.append(torch.zeros((), dtype=torch.float64, device=pred.device))
        else:
            out.append(2 * (a * b).sum() / (sa + sb))
    return torch.stack(out)


def evaluate(logits: torch.Tensor, gts: torch.Tensor, chosen: torch.Tensor) -> Dict[str, torch.Tensor]:
    classes = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    labels = logits.argmax(1)
    mean_pred = probs.mean(0).argmax(0)
    return {"ged": ged(labels, gts, classes), "ncc": variance_ncc(probs, gts, classes),
            "dice": dice(mean_pred, chosen, classes), "mean_pred": mean_pred, "sample0": labels[0]}
