"""Adam with the L2 term coupled (added to the gradient before the moments,
as ``torch.optim.Adam(weight_decay=...)``), at the rate of a
ReduceLROnPlateau on each step's loss (mode min, threshold 1e-4 relative,
no cooldown), as UNet-Zoo's training loop steps them."""

from __future__ import annotations

import math
from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, factor: float = 0.1, patience: int = 50_000,
                 min_lr: float = 1e-4):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.factor, self.patience, self.min_lr = factor, patience, min_lr
        self.best, self.bad, self.t = math.inf, 0, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], loss: float) -> Dict:
        """Updates ``params`` in place; returns the gradients the moments took
        (the L2 term added)."""
        if loss < self.best * (1 - 1e-4):
            self.best, self.bad = loss, 0
        else:
            self.bad += 1
        if self.bad > self.patience:
            self.lr, self.bad = max(self.lr * self.factor, self.min_lr), 0
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = {}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + self.wd * p
                taken[k] = g
                self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
                self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
                p.sub_(self.lr / bc1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(bc2) + self.eps))
        return taken
