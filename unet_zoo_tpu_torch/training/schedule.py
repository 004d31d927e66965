"""ReduceLROnPlateau on the device, the twin of ``unet_zoo_tpu.training.schedule``.

The reference steps torch's ReduceLROnPlateau every iteration on the train
loss. ``torch.optim.lr_scheduler.ReduceLROnPlateau.step`` needs the loss as a
host float, a sync per step; here the state is 0-d device tensors and the
update is ``torch.where`` only, so the step never waits for the device.

Semantics are torch's defaults (mode='min', threshold=1e-4 relative,
cooldown=0): the loss improves if loss < best * (1 - threshold); after more
than ``patience`` consecutive non-improvements, lr <- max(lr * factor, min_lr).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PlateauState(NamedTuple):
    lr: torch.Tensor  # current learning rate, f32 scalar
    best: torch.Tensor  # best loss seen, f32 scalar
    num_bad: torch.Tensor  # consecutive non-improving steps, i32 scalar


def plateau_init(lr: float, device=None) -> PlateauState:
    return PlateauState(
        lr=torch.tensor(lr, dtype=torch.float32, device=device),
        best=torch.tensor(float("inf"), dtype=torch.float32, device=device),
        num_bad=torch.tensor(0, dtype=torch.int32, device=device),
    )


def plateau_update(state: PlateauState, loss: torch.Tensor, factor: float = 0.1,
                   patience: int = 50_000, min_lr: float = 1e-4,
                   threshold: float = 1e-4) -> PlateauState:
    loss = loss.detach().float()
    improved = loss < state.best * (1.0 - threshold)
    best = torch.where(improved, loss, state.best)
    num_bad = torch.where(improved, 0, state.num_bad + 1).to(torch.int32)
    reduce = num_bad > patience
    lr = torch.where(reduce, torch.clamp(state.lr * factor, min=min_lr), state.lr)
    num_bad = torch.where(reduce, 0, num_bad).to(torch.int32)
    return PlateauState(lr=lr, best=best, num_bad=num_bad)
