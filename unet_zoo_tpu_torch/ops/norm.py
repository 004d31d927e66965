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
the float32 sums of x and x^2 all-reduced over the group and divided by the
global count, ``var = max(E[x^2] - E[x]^2, 0)`` (``_SyncedBatchNorm``,
whose backward all-reduces its two sums of the gradient too), and the
running variance's unbiased count ``n * world`` (under spatial sharding,
``parallel/space.py``, the count of distinct values: a replicated level's
copies are counted once). The group is an attribute,
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

from unet_zoo_tpu_torch.parallel import space as space_lib

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


def group_counts(y: torch.Tensor, group, sp=None) -> Tuple[int, int]:
    """Per channel of channels-last ``y``, the values summed over ``group``
    (local count x world size: what the means divide by) and the distinct
    ones among them (what the unbiased variance reads). Under spatial
    sharding (``sp``, with the whole mesh's ``group``) a replicated level's
    ``sp.size`` copies scale the sums and the first count alike, and the
    second counts them once."""
    n = y.numel() // y.shape[-1] * dist.get_world_size(group)
    return n, (n // sp.size if sp is not None and not sp.is_sharded(y) else n)


def group_moments(y: torch.Tensor, group, sp=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The float32 (or float64) per-channel ``mean`` and ``max(E[y^2] -
    E[y]^2, 0)`` of channels-last ``y`` over every axis but the last, taken
    over the global batch of ``group`` (one all-reduce of both sums), and
    the count of distinct values a channel (``group_counts``)."""
    axes = tuple(range(y.ndim - 1))
    n, distinct = group_counts(y, group, sp)
    mean, mean_sq = space_lib.all_reduce_sum(torch.stack([y.sum(axes), y.square().sum(axes)]), group) / n
    return mean, torch.clamp_min(mean_sq - mean.square(), 0.0), distinct


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over ``group`` by the JAX formula:
    ``apply(x, weight, bias, group, eps, count)`` returns (y, mean, var),
    the statistics taken over ``count`` values a channel (one all-reduce of
    the float32 sums of x and x^2; ``var = max(E[x^2] - E[x]^2, 0)``). It
    keeps only x, in its own dtype, and the per-channel statistics for the
    backward, as ``F.batch_norm`` does (autograd of the formula would keep
    three more tensors of x's size), and the backward's two per-channel
    sums take one all-reduce: ``dx = w s (dy - mean(dy) - x_hat mean(dy
    x_hat))`` with the group's means, the x_hat term dropped where the
    variance was clamped to 0; the weight's and the bias's gradients are
    this process's part."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, group, eps: float, count: int):
        xf = x.float()
        axes = tuple(range(x.ndim - 1))
        sums = torch.stack([xf.sum(axes), xf.square().sum(axes)])
        dist.all_reduce(sums, group=group)
        mean, mean_sq = sums / count
        raw = mean_sq - mean.square()
        var = torch.clamp_min(raw, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean) * invstd * weight + bias
        ctx.save_for_backward(x, mean, invstd, weight, raw > 0)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy: torch.Tensor, *_):
        x, mean, invstd, weight, unclamped = ctx.saved_tensors
        axes = tuple(range(x.ndim - 1))
        gy = gy.float()
        x_hat = (x.float() - mean) * invstd
        local = torch.stack([gy.sum(axes), (gy * x_hat).sum(axes)])
        g_bias, g_weight = local.clone()
        dist.all_reduce(local, group=ctx.group)
        mean_gy, mean_gy_xhat = local / ctx.count
        gx = (gy - mean_gy - x_hat * (mean_gy_xhat * unclamped)) * (invstd * weight)
        return gx.to(x.dtype), g_weight, g_bias, None, None, None


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
        """Train mode over the process group's global batch
        (``_SyncedBatchNorm``); under spatial sharding the unbiased
        variance counts a replicated level's values once."""
        count, n = group_counts(x, self.process_group, space_lib.current())
        y, mean, var = _SyncedBatchNorm.apply(x, self.weight, self.bias, self.process_group, self.eps, count)
        if not is_recomputing():
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
        return y
