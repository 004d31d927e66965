"""Probabilistic U-Net, the twin of ``unet_zoo_tpu.models.prob_unet`` (NHWC), in the three memory modes.

Structure (reference models/probabilistic_unet.py:202-370):

* the trunk: a U-Net without its 1x1 output conv (``UNet(apply_last_layer=
  False)``), whose BN-free blocks run the conv-chain kernel on the card (39
  launches a forward at the ``prob_unet`` experiment's 7 levels);
* prior and posterior ``_LatentGaussian`` nets (the posterior with
  ``one_hot(mask) - 0.5`` concatenated to the image): a conv + BatchNorm +
  ReLU pyramid (``_Encoder``), the spatial mean, and a 1x1 head giving mu
  and sigma = exp(log_sigma) of an axis-aligned Gaussian over
  ``latent_dim`` dimensions;
* ``_Fcomb``: z broadcast over space and concatenated after the trunk's
  features, ``no_convs_fcomb - 1`` 1x1 conv + BatchNorm + ReLU and a 1x1
  ``last`` conv;
* ``last_conv``: a deterministic 1x1 head on the features (``logits``),
  which no loss term reads.

The loss: the batch mean of the pixel-summed CE of ``recon`` (the decoded
posterior sample), plus the KL of posterior from prior (``kl_parity``: the
reference's ``sigma1 * sigma0`` quirk), plus ``REG_WEIGHT`` times the sum
of the L2 norms of every parameter of the two Gaussian nets and of
``fcomb`` except ``fcomb.last`` (``regularized_parameters``).

``self.training`` stands where the JAX package passes ``train``: it selects
BatchNorm's batch or running statistics. Randomness: the posterior's z noise
(``post_eps`` of ``forward``, (B, latent_dim)) and ``sample``'s ((B, n,
latent_dim)) can be passed in; otherwise they are drawn from ``generator``,
by default the model's own device generator (``self.generator``).

Cast points (bf16 ``dtype``) as in the JAX package: the posterior's one-hot
takes the image's dtype; the encoders' and ``fc{i}``'s convs compute in
``dtype``; the spatial mean is taken in float32 and rounded to the
encoder's dtype, and the 1x1 head's product is float32; z is cast to the
features' dtype; ``fcomb.last`` and ``last_conv`` take no dtype and compute
in their input's, so ``recon`` and ``logits`` are bf16 and the CE float32.

Memory modes (``reversible_mode``): "remat" runs every conv sequence under
``ops.remat`` with the plain parameters; "reversible" makes each trunk
block a ``ReversibleSequence`` of 3 coupling blocks and each encoder level
one of ``depth_per_block - 1`` = 2 (``rev{i}``), as the reference does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.models.unet import UNet, softmax_cross_entropy

# the weight of the sum of parameter norms in the loss (reference :368-370)
REG_WEIGHT = 1e-5
# inside each norm's square root: the gradient of ||w|| at w = 0 stays 0
NORM_EPS = 1e-12


class _Encoder(nn.Module):
    """Conv pyramid: per level, a ceil-mode 2x2 average pool (but before the
    first), then ``depth_per_block`` he_normal conv + BatchNorm + ReLU
    (``block{i}``), or in "reversible" mode ``depth_per_block - 1`` coupling
    blocks (``rev{i}``, reference :60)."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], depth_per_block: int = 3,
                 reversible_mode: str = "plain", dtype=None, device=None, generator=None):
        super().__init__()
        c = in_channels
        for i, f in enumerate(num_filters):
            name = f"rev{i}" if reversible_mode == "reversible" else f"block{i}"
            self.add_module(name, ops.conv_sequence(
                c, f, depth_per_block, mode=reversible_mode, rev_depth=depth_per_block - 1, norm=True,
                init_scheme="he_normal", dtype=dtype, device=device, generator=generator))
            c = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, level in enumerate(self.children()):
            if i != 0:
                x = ops.avg_pool_ceil(x)
            x = level(x)
        return x


class _LatentGaussian(nn.Module):
    """The reference's AxisAlignedConvGaussian (:73-130): encoder, spatial
    mean, 1x1 head -> (mu, sigma), each (B, latent_dim) float32. The head's
    ``head_kernel`` is OIHW (2 latent_dim, F, 1, 1), kaiming-normal;
    ``head_bias`` is N(0, 1)."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], latent_dim: int, num_classes: int = 2,
                 posterior: bool = False, reversible_mode: str = "plain", dtype=None, device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.posterior = posterior
        self.encoder = _Encoder(in_channels + (num_classes if posterior else 0), num_filters,
                                reversible_mode=reversible_mode, dtype=dtype, device=device, generator=generator)
        shape = (2 * latent_dim, num_filters[-1], 1, 1)
        self.head_kernel = nn.Parameter(ops.kaiming_normal_fan_in(shape, generator).to(device))
        self.head_bias = nn.Parameter(torch.randn(shape[0], generator=generator).to(device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.posterior:
            if mask is None:
                raise ValueError("the posterior needs the mask")
            onehot = F.one_hot(mask.long(), self.num_classes).to(x.dtype)
            x = torch.cat([x, onehot - 0.5], dim=-1)
        enc = self.encoder(x)
        pooled = enc.float().mean((1, 2)).to(enc.dtype)
        out = pooled.float() @ self.head_kernel.flatten(1).t() + self.head_bias
        mu, log_sigma = out.chunk(2, dim=-1)
        return mu, torch.exp(log_sigma)


class _Fcomb(nn.Module):
    """Latent-conditioned head (reference :133-199): z (B, d) broadcast over
    space and concatenated after the features, ``no_convs_fcomb - 1``
    orthogonal 1x1 conv + BatchNorm + ReLU (``fc{i}``), a 1x1 ``last``."""

    def __init__(self, features0: int, latent_dim: int, num_classes: int, no_convs_fcomb: int = 4, dtype=None,
                 device=None, generator=None):
        super().__init__()
        self.depth = no_convs_fcomb - 1
        c = features0 + latent_dim
        for i in range(self.depth):
            self.add_module(f"fc{i}", ops.ConvBNAct(c, features0, kernel_size=1, init_scheme="orthogonal",
                                                    dtype=dtype, device=device, generator=generator))
            c = features0
        self.last = ops.Conv(c, num_classes, kernel_size=1, init_scheme="orthogonal", device=device,
                             generator=generator)

    def forward(self, feat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        zb = z.to(feat.dtype)[:, None, None, :].expand(*feat.shape[:-1], z.shape[-1])
        x = torch.cat([feat, zb], dim=-1)
        for i in range(self.depth):
            x = getattr(self, f"fc{i}")(x)
        return self.last(x)


class _SumOfNorms(torch.autograd.Function):
    """sum_i sqrt(sum(w_i^2) + NORM_EPS) over float32 tensors w_i, with
    the gradient g * w_i / sqrt(sum(w_i^2) + NORM_EPS). A handful of
    launches each way for all the tensors (multi-tensor norms, then one
    product over their concatenation), where autograd of a norm a tensor
    would issue a few launches for every one of them."""

    @staticmethod
    def forward(ctx, *params: torch.Tensor) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(params))
        roots = torch.sqrt(norms.square() + NORM_EPS)
        ctx.save_for_backward(roots, *params)
        return roots.sum()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        roots, *params = ctx.saved_tensors
        scale = (grad / roots).unbind()
        flat = torch.cat([p.reshape(-1) for p in params])
        flat = flat * torch.cat([s.expand(p.numel()) for s, p in zip(scale, params)])
        return tuple(g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params))


class ProbUNet(nn.Module):
    """The Probabilistic U-Net on NHWC input. ``in_channels`` is explicit
    here (the JAX model infers it at init)."""

    def __init__(self, num_classes: int, num_filters: Sequence[int] = (32, 64, 128, 192), latent_dim: int = 6,
                 no_convs_fcomb: int = 4, in_channels: int = 1, reversible_mode: str = "plain",
                 kl_parity: bool = True, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if no_convs_fcomb < 1:
            raise ValueError(f"no_convs_fcomb must be >= 1, got {no_convs_fcomb}")
        self.kl_parity = kl_parity
        num_filters = tuple(num_filters)
        kw = dict(reversible_mode=reversible_mode, dtype=dtype, device=device, generator=generator)
        self.unet = UNet(num_classes, num_filters, in_channels, apply_last_layer=False, **kw)
        self.prior_net = _LatentGaussian(in_channels, num_filters, latent_dim, num_classes, posterior=False, **kw)
        self.posterior_net = _LatentGaussian(in_channels, num_filters, latent_dim, num_classes, posterior=True, **kw)
        self.fcomb = _Fcomb(num_filters[0], latent_dim, num_classes, no_convs_fcomb, dtype=dtype, device=device,
                            generator=generator)
        self.last_conv = ops.ConvBNAct(num_filters[0], num_classes, kernel_size=1, norm=False, act=False,
                                       init_scheme="torch_default", device=device, generator=generator)
        # the default source of z noise, seeded from the weights' generator
        seed = int(torch.randint(2 ** 62, (1,), generator=generator).item())
        self.generator = torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, post_eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x (B, H, W, C); mask (B, H, W) int. Returns the prior's
        ``prior_mu``/``prior_sigma``, the trunk's ``features`` and, in eval
        mode, the deterministic ``logits`` (no loss term reads them, so the
        train step skips ``last_conv``, as XLA drops it from the JAX step);
        with ``mask`` also the posterior's ``post_mu``/``post_sigma`` and
        ``recon``, the decoded posterior sample z = mu + sigma * ``post_eps``
        (drawn from ``generator`` if not given), in train and in eval mode
        alike."""
        out: Dict[str, torch.Tensor] = {}
        out["prior_mu"], out["prior_sigma"] = self.prior_net(x)
        if mask is not None:
            out["post_mu"], out["post_sigma"] = self.posterior_net(x, mask)
        feat = self.unet(x)
        out["features"] = feat
        if not self.training:
            out["logits"] = self.last_conv(feat)
        if mask is not None:
            mu, sigma = out["post_mu"], out["post_sigma"]
            if post_eps is None:
                post_eps = torch.randn(mu.shape, generator=generator or self.generator, device=mu.device)
            out["recon"] = self.fcomb(feat, mu + sigma * post_eps)
        return out

    def sample(self, x: torch.Tensor, n: int, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n prior samples, with BatchNorm's running statistics whatever the
        mode: the trunk and the prior run once, ``fcomb`` once on the n * B
        samples folded into the batch image-major (image 0's n samples,
        then image 1's, as the JAX package's ``jnp.repeat``). ``eps`` is
        (B, n, latent_dim). Returns logits (B, n, H, W, classes)."""
        was_training = self.training
        self.eval()
        try:
            mu, sigma = self.prior_net(x)
            feat = self.unet(x)
            batch = x.shape[0]
            if eps is None:
                eps = torch.randn((batch, n, mu.shape[-1]), generator=generator or self.generator, device=mu.device)
            z = mu[:, None] + sigma[:, None] * eps
            logits = self.fcomb(feat.repeat_interleave(n, dim=0), z.reshape(batch * n, -1))
        finally:
            self.train(was_training)
        return logits.reshape(batch, n, *logits.shape[1:])

    # the loss (reference :343-370)

    def regularized_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """The parameters whose norms the loss sums: every parameter of the
        prior and posterior nets and of ``fcomb`` but ``fcomb.last``
        (BatchNorm's scales and shifts count, its running statistics are
        buffers and do not)."""
        named = [*self.prior_net.named_parameters(prefix="prior_net"),
                 *self.posterior_net.named_parameters(prefix="posterior_net"),
                 *self.fcomb.named_parameters(prefix="fcomb")]
        return [(n, p) for n, p in named if not n.startswith("fcomb.last.")]

    def loss(self, out: Dict[str, torch.Tensor], mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE + KL + REG_WEIGHT * sum of parameter norms. ``last_conv``,
        which no term reads, gets an exact zero gradient (0 times its sum),
        as ``jax.grad`` gives it, so that coupled-L2 Adam still moves it by
        its weight decay; a parameter with no gradient would be skipped."""
        ce = softmax_cross_entropy(out["recon"], mask)
        recon = ce.reshape(ce.shape[0], -1).sum(1).mean()
        kl = kl_two_gauss_diag(out["post_mu"], out["post_sigma"], out["prior_mu"], out["prior_sigma"],
                               parity=self.kl_parity)
        reg = _SumOfNorms.apply(*(p for _, p in self.regularized_parameters()))
        untouched = sum(p.sum() for p in self.last_conv.parameters()) * 0.0
        loss = recon + kl + REG_WEIGHT * reg + untouched
        return loss, {"loss": loss, "kl": kl, "recon": recon}


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
