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
rounding only (``tests/test_torch_ops.py`` holds them together).

Cross-rank BatchNorm, the twin of the JAX module's ``axis_name``: where
``process_group`` is set (``parallel.mesh.sync_batch_norm``) a train-mode
BatchNorm takes the JAX formula over the group's global batch: per channel
the float32 sums of x and x^2 all-reduced over the group
(``all_reduce_sum``, whose backward all-reduces the gradient too) and
divided by the global count, ``var = max(E[x^2] - E[x]^2, 0)``, and the
running variance's unbiased count ``n * world``. The group is an attribute,
not a context, because on a card the backward (and a recompute inside it)
runs on autograd's device thread.

Under ``recomputing()`` (the backward's re-run of a checkpointed sequence,
``ops/conv.py`` ``remat``) a train-mode BatchNorm normalises with the batch
statistics and leaves the running ones alone: the forward already folded
this batch in once, as the JAX package's ``nn.remat`` mutates
``batch_stats`` once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.distributed as dist
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


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``t`` over ``group``; the backward is the sum of the
    gradients over the group, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``t`` over the process ``group``."""
    return _AllReduceSum.apply(t, group)


def group_moments(y: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The float32 (or float64) per-channel ``mean`` and ``max(E[y^2] -
    E[y]^2, 0)`` of channels-last ``y`` over every axis but the last, taken
    over the global batch of ``group`` (one all-reduce of both sums), and
    the global count a channel."""
    axes = tuple(range(y.ndim - 1))
    n = y.numel() // y.shape[-1] * dist.get_world_size(group)
    mean, mean_sq = all_reduce_sum(torch.stack([y.sum(axes), y.square().sum(axes)]), group) / n
    return mean, torch.clamp_min(mean_sq - mean.square(), 0.0), n


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.01, eps: float = 1e-3, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.process_group = None  # set for cross-rank statistics in train mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise NHWC or NDHWC ``x`` over every axis but the channels; in
        train mode the running statistics update in place (no host sync),
        except in a recompute."""
        if self.training and self.process_group is not None:
            return self._synced(x)
        # channels moved to axis 1: a channels_last(_3d) view, taken without a copy
        mean, var = self.running_mean, self.running_var
        if self.training and is_recomputing():
            # throwaway copies take the update: the same op saves the same
            # tensors for the backward as in the forward, which checkpoint checks
            mean, var = mean.clone(), var.clone()
        y = F.batch_norm(x.float().movedim(-1, 1), mean, var, self.weight, self.bias, self.training,
                         self.momentum, self.eps)
        return y.movedim(1, -1).to(x.dtype)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the process group's global batch."""
        xf = x.float()
        mean, var, n = group_moments(xf, self.process_group)
        if not is_recomputing():
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)
