"""BatchNorm with torch semantics, the twin of ``unet_zoo_tpu.ops.norm.BatchNorm``.

eps 1e-3 and momentum 0.01 (torch style: the weight of the new batch
statistic), as the reference wraps every PHiSeg conv. Statistics are taken
in float32 over every axis but the trailing channel axis (NHWC or NDHWC); the
running variance takes the unbiased batch variance, ``n / (n - 1)``; eval
mode normalises with the running statistics; the output has the input's
dtype. ``weight``/``bias`` are float32 parameters, ``running_mean``/
``running_var`` float32 buffers starting at 0 and 1.

The math is ``F.batch_norm`` on the float32 input, one fused library op
each way on the card. It takes the variance in one Welford pass where the
JAX module takes ``max(E[x^2] - E[x]^2, 0)``; the two differ in float32
rounding only (``tests/test_torch_ops.py`` holds them together). Sync-BN
over several cards (the JAX module's ``axis_name``) is not ported.

Under ``recomputing()`` (the backward's re-run of a checkpointed sequence,
``ops/conv.py`` ``remat``) a train-mode BatchNorm normalises with the batch
statistics and leaves the running ones alone: the forward already folded
this batch in once, as the JAX package's ``nn.remat`` mutates
``batch_stats`` once.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

_state = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks a checkpoint's recompute on this thread (where autograd runs it)."""
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def is_recomputing() -> bool:
    return getattr(_state, "depth", 0) > 0


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.01, eps: float = 1e-3, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise NHWC or NDHWC ``x`` over every axis but the channels; in
        train mode the running statistics update in place (no host sync),
        except in a recompute."""
        # channels moved to axis 1: a channels_last(_3d) view, taken without a copy
        mean, var = self.running_mean, self.running_var
        if self.training and is_recomputing():
            # throwaway copies take the update: the same op saves the same
            # tensors for the backward as in the forward, which checkpoint checks
            mean, var = mean.clone(), var.clone()
        y = F.batch_norm(x.float().movedim(-1, 1), mean, var, self.weight, self.bias, self.training,
                         self.momentum, self.eps)
        return y.movedim(1, -1).to(x.dtype)
