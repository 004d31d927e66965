"""Probabilistic U-Net, the twin of ``unet_zoo_tpu.models.prob_unet``.

Only the KL term is ported so far; PHiSeg's hierarchical KL sums it over
its latent levels. The model itself is not ported yet.
"""

from __future__ import annotations

import torch


def kl_two_gauss_diag(mu0: torch.Tensor, sigma0: torch.Tensor, mu1: torch.Tensor, sigma1: torch.Tensor,
                      parity: bool = True, eps: float = 1e-10) -> torch.Tensor:
    """KL(N(mu0, sigma0^2) || N(mu1, sigma1^2)) in float32, the batch mean of
    per-sample sums.

    ``parity=True`` reproduces the reference's ``sigma1 * sigma0`` in place of
    ``sigma1^2`` (reference models/probabilistic_unet.py:294,
    models/phiseg.py:439), as the JAX package does by default.
    """
    mu0, sigma0, mu1, sigma1 = (t.reshape(t.shape[0], -1).float() for t in (mu0, sigma0, mu1, sigma1))
    s0sq = sigma0 * sigma0
    s1sq = sigma1 * sigma0 if parity else sigma1 * sigma1
    term = (s0sq + (mu1 - mu0) ** 2) / (s1sq + eps)
    return (0.5 * (term + torch.log(s1sq + eps) - torch.log(s0sq + eps) - 1.0).sum(1)).mean()
