"""Layers of the reference, written out on NCHW float32 tensors.

A parameter dict ``p`` maps a module path to its tensor; a buffer dict
``bufs`` holds BatchNorm's running statistics under the same paths. A
convolution that BatchNorm follows takes its bias detached: the published
models stop that gradient (it is ~0 through BatchNorm), and the optimizer
then sees a zero gradient there.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.01
KL_EPS = 1e-10

Params = Dict[str, torch.Tensor]

_momentum = [BN_MOMENTUM]


@contextlib.contextmanager
def one_batch_statistics():
    """Train-mode BatchNorm sets the running statistics to the batch's own
    (momentum 1) inside the block."""
    _momentum.append(1.0)
    try:
        yield
    finally:
        _momentum.pop()


def conv(p: Params, name: str, x: torch.Tensor, bias_grad: bool = True) -> torch.Tensor:
    """``name.weight`` (O, I, k, k) and ``name.bias`` with 'same' padding for k = 3, none for k = 1."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    return F.conv2d(x, w, b if bias_grad else b.detach(), padding=w.shape[-1] // 2)


def batch_norm(p: Params, bufs: Optional[Params], name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Train mode: the batch's mean and biased variance per channel, and the
    running statistics (in ``bufs``, where given) moved by momentum 0.01
    toward the mean and the unbiased variance. Eval mode: the running ones."""
    if train:
        mean = x.mean((0, 2, 3))
        var = (x - mean[:, None, None]).square().mean((0, 2, 3))
        if bufs is not None:
            n, m = x.numel() // x.shape[1], _momentum[-1]
            with torch.no_grad():
                bufs[f"{name}.running_mean"].mul_(1 - m).add_(m * mean)
                bufs[f"{name}.running_var"].mul_(1 - m).add_(m * var * n / (n - 1))
    else:
        mean, var = bufs[f"{name}.running_mean"], bufs[f"{name}.running_var"]
    scale = p[f"{name}.weight"] / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * scale[:, None, None] + p[f"{name}.bias"][:, None, None]


def conv_bn_relu_seq(p: Params, bufs: Optional[Params], name: str, x: torch.Tensor, depth: int,
                     train: bool) -> torch.Tensor:
    """``depth`` stages of 3x3 conv (bias without gradient), BatchNorm and ReLU: ``name.conv{i}``."""
    for i in range(depth):
        stage = f"{name}.conv{i}"
        x = conv(p, f"{stage}.conv", x, bias_grad=False)
        x = torch.relu(batch_norm(p, bufs, f"{stage}.bn", x, train))
    return x


def conv_relu_seq(p: Params, name: str, x: torch.Tensor, depth: int) -> torch.Tensor:
    """``depth`` stages of 3x3 conv with bias and ReLU: ``name.conv{i}.conv``."""
    for i in range(depth):
        x = torch.relu(conv(p, f"{name}.conv{i}.conv", x))
    return x


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, a partial window averaging its pixels."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True)


def resize(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


def upsample_nearest(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="nearest")


def pixel_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy a pixel: logits (B, C, H, W), integer labels (B, H, W)."""
    return F.cross_entropy(logits, labels.long(), reduction="none")


def kl_diag(mu0, sigma0, mu1, sigma1) -> torch.Tensor:
    """KL(N(mu0, sigma0^2) || N(mu1, sigma1^2)), the batch mean of per-image
    sums, with the published code's ``sigma1 * sigma0`` in place of
    ``sigma1 ** 2`` (PHiSeg's ``kl_two_gauss``)."""
    s0sq = sigma0 * sigma0
    s1sq = sigma1 * sigma0
    term = (s0sq + (mu1 - mu0) ** 2) / (s1sq + KL_EPS)
    kl = 0.5 * (term + torch.log(s1sq + KL_EPS) - torch.log(s0sq + KL_EPS) - 1.0)
    return kl.reshape(kl.shape[0], -1).sum(1).mean()
