"""Variance-NCC, the twin of ``unet_zoo_tpu.metrics.ncc``: the normalised
cross-correlation between the samples' disagreement map and each
annotator's sample-disagreement map.

* E_ss(x)   = mean_i CE(sample_i(x), mean_seg(x)), a pixelwise map;
* E_sy_j(x) = mean_i CE(sample_i(x), gt_j(x));
* score     = mean_j of the zero-normalised cross-correlation of E_ss and E_sy_j.

The standard deviations are the population's (``correction=0``, as
``jnp.std``), ``ncc`` adds no epsilon and the log adds 1e-8: a constant
error map gives NaN, as in the JAX package.
"""

from __future__ import annotations

import torch

_LOG_EPS = 1e-8


def ncc(a: torch.Tensor, v: torch.Tensor, zero_norm: bool = True, eps: float = 0.0) -> torch.Tensor:
    """Normalised cross-correlation of two maps of the same size."""
    a = a.reshape(-1).float()
    v = v.reshape(-1).float()
    if zero_norm:
        a = (a - a.mean()) / (a.std(correction=0) * a.shape[0] + eps)
        v = (v - v.mean()) / (v.std(correction=0) + eps)
    else:
        a = a / (a.std(correction=0) * a.shape[0] + eps)
        v = v / (v.std(correction=0) + eps)
    return (a * v).sum()


def _pixel_wise_xent(samp: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CE over the trailing class axis of probabilities ``samp`` against ``gt``."""
    return -(gt * torch.log(samp + _LOG_EPS)).sum(-1)


def variance_ncc_dist(sample_arr: torch.Tensor, gt_arr: torch.Tensor) -> torch.Tensor:
    """sample_arr (N, *S, C) softmax probabilities, gt_arr (M, *S, C) one-hot:
    the mean over the annotators of the NCC, a float32 scalar."""
    sample_arr = sample_arr.float()
    gt_arr = gt_arr.float()
    mean_seg = sample_arr.mean(0)
    e_ss = _pixel_wise_xent(sample_arr, mean_seg[None]).mean(0)  # (*S,)
    e_sy = _pixel_wise_xent(sample_arr[None], gt_arr[:, None]).mean(1)  # (M, *S)
    return torch.stack([ncc(e_ss, e_sy[j]) for j in range(gt_arr.shape[0])]).mean()


def variance_ncc_dist_class_first(sample_cf: torch.Tensor, gt_cf: torch.Tensor) -> torch.Tensor:
    """:func:`variance_ncc_dist` with the class axis first: sample_cf (C, N,
    *S) softmax probabilities, gt_cf (C, M, *S) one-hot. The same sums in
    another axis order."""
    sample_cf = sample_cf.float()
    gt_cf = gt_cf.float()
    log_s = torch.log(sample_cf + _LOG_EPS)
    mean_seg = sample_cf.mean(1)  # (C, *S)
    e_ss = -(mean_seg[:, None] * log_s).sum(0).mean(0)  # (*S,)
    e_sy = -(gt_cf[:, :, None] * log_s[:, None]).sum(0).mean(1)  # (M, *S)
    return torch.stack([ncc(e_ss, e_sy[j]) for j in range(gt_cf.shape[1])]).mean()
