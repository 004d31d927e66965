"""The Probabilistic U-Net (Kohl et al., NeurIPS 2018, arXiv:1806.05034),
the reference.

Written from the published model (gigantenbein/UNet-Zoo
``models/probabilistic_unet.py`` and its experiment ``prob_unet.py``) on
NCHW float32 tensors:

* the trunk: ``reference/unet.py``'s U-Net (``len(filters)`` levels of 3
  BN-free conv + ReLU, He-normal kernels, a 2x2 average pool before each
  level but the first, bilinear resizes up the path) without its 1x1
  ``last``: the features of the finest level;
* prior and posterior nets: each a pyramid of ``len(filters)`` levels of 3
  conv + BatchNorm + ReLU (He-normal kernels; the posterior sees
  ``one_hot(mask) - 0.5`` beside the image), the spatial mean, and a 1x1
  head to (mu, log sigma) over ``latent_dim`` (He-normal kernel, N(0, 1)
  bias); sigma = exp(log sigma);
* fcomb: z = mu + sigma * eps, one vector an image, broadcast over space
  and concatenated after the features; ``no_convs_fcomb - 1`` 1x1 conv +
  BatchNorm + ReLU, then a 1x1 ``last``;
* ``last_conv``, a deterministic 1x1 head that no loss term reads;
* the loss: the batch mean of the pixel-summed cross-entropy of fcomb's
  logits, plus the KL of posterior from prior, plus ``REG_WEIGHT`` times the
  sum of the L2 norms of every prior, posterior and fcomb parameter but
  fcomb's ``last`` (BatchNorm's scales and shifts count, its running
  statistics do not).

In training the posterior's sample is decoded and every BatchNorm takes the
batch's statistics; ``sample`` decodes prior samples with the running ones.

Departures from UNet-Zoo, each kept on purpose:

* the KL takes the published code's ``sigma1 * sigma0`` in place of
  ``sigma1 ** 2`` (``ops.kl_diag``), as the registered experiment's
  ``kl_parity`` states; a configuration without it is refused;
* fcomb's orthogonal 1x1 kernels are drawn as normals of the same scale,
  1/sqrt(fan_in) (an orthogonal matrix with fewer rows than columns has
  entries of that root mean square): the benchmark draws uniform, normal
  and constant leaves only, and agreement needs the same weights on both
  sides, not the published distribution;
* ``last_conv`` enters the loss as 0 times the sum of its parameters, so its
  gradient is an exact zero and coupled-L2 Adam still moves it by its
  weight decay, as ``jax.grad`` and the port give it;
* each norm is sqrt(sum(w^2) + ``NORM_EPS``), whose gradient stays finite at
  w = 0, as in the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import ops, unet

ENCODER_DEPTH = 3
REG_WEIGHT = 1e-5
NORM_EPS = 1e-12

# the benchmark's tests' size: three levels, 16x16; the latent size and fcomb's depth as published
TINY = dict(filter_channels=(4, 8, 8), image_size=(16, 16))


class Model:
    """The sizes of one configuration: ``filters``, ``latent_dim``,
    ``no_convs_fcomb``, ``classes``, ``image_size``, ``in_channels``."""

    def __init__(self, filters: Sequence[int], latent_dim: int, no_convs_fcomb: int, classes: int,
                 image_size: Sequence[int], in_channels: int = 1):
        self.trunk = unet.Model(filters, classes, image_size, in_channels)
        self.f = tuple(filters)
        self.latent_dim, self.fcomb_depth = latent_dim, no_convs_fcomb - 1
        self.C = classes
        self.image_size = tuple(image_size)
        self.in_channels = in_channels

    # the conv-chain kernel's stages: the trunk's 3-conv blocks

    def blocks(self) -> List[Tuple[str, int, int]]:
        return self.trunk.blocks()

    def block_sizes(self) -> Dict[str, tuple]:
        return self.trunk.block_sizes()

    # parameters

    def specs(self) -> List[Tuple[str, tuple, tuple]]:
        """(path, shape, init) of every parameter and buffer, under the
        port's paths. Inits: ("he_normal", std) and ("trunc_normal", std)
        normals, ("uniform", bound), ("const", value)."""
        out = [(f"unet.{name}", shape, init) for name, shape, init in self.trunk.specs()
               if not name.startswith("last.")]

        def conv_bn(name, ci, co, k, std):
            out.append((f"{name}.conv.weight", (co, ci, k, k), ("he_normal", std)))
            out.append((f"{name}.conv.bias", (co,), ("trunc_normal", 1e-3)))
            for leaf, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
                out.append((f"{name}.bn.{leaf}", (co,), ("const", v)))

        for net, c in (("prior_net", self.in_channels), ("posterior_net", self.in_channels + self.C)):
            for i, fi in enumerate(self.f):
                for j in range(ENCODER_DEPTH):
                    cin = c if j == 0 else fi
                    conv_bn(f"{net}.encoder.block{i}.conv{j}", cin, fi, 3, (2.0 / (9 * cin)) ** 0.5)
                c = fi
            out.append((f"{net}.head_kernel", (2 * self.latent_dim, c, 1, 1), ("he_normal", (2.0 / c) ** 0.5)))
            out.append((f"{net}.head_bias", (2 * self.latent_dim,), ("he_normal", 1.0)))
        c = self.f[0] + self.latent_dim
        for i in range(self.fcomb_depth):
            conv_bn(f"fcomb.fc{i}", c, self.f[0], 1, c ** -0.5)
            c = self.f[0]
        out.append(("fcomb.last.weight", (self.C, c, 1, 1), ("he_normal", c ** -0.5)))
        out.append(("fcomb.last.bias", (self.C,), ("trunc_normal", 1e-3)))
        bound = self.f[0] ** -0.5
        out.append(("last_conv.conv.weight", (self.C, self.f[0], 1, 1), ("uniform", bound)))
        out.append(("last_conv.conv.bias", (self.C,), ("uniform", bound)))
        return out

    def regularized(self, p) -> List[torch.Tensor]:
        """The parameters whose norms the loss sums."""
        return [t for name, t in p.items() if name.startswith(("prior_net.", "posterior_net.", "fcomb."))
                and not name.startswith("fcomb.last.")]

    # the noise: one (B, latent_dim) vector an image, the same layout in the program and here

    def noise_shapes(self, batch: int) -> tuple:
        """A train step's posterior noise as the program's ``train_step``
        takes its ``z_eps``: one (batch, latent_dim) tensor."""
        return (batch, self.latent_dim)

    def to_reference(self, eps):
        return eps

    # the nets

    def features(self, p, x: torch.Tensor) -> torch.Tensor:
        """The trunk's output: ``unet.Model.forward`` without its ``last``."""
        n = len(self.f)
        skips = []
        for i in range(n):
            if i:
                x = ops.avg_pool(x)
            x = ops.conv_relu_seq(p, f"unet.down{i}.convs", x, unet.DEPTH)
            if i != n - 1:
                skips.append(x)
        for i in range(n - 2, -1, -1):
            x = ops.resize(x, skips[i].shape[2:], align_corners=False)
            x = ops.conv_relu_seq(p, f"unet.up{i}.convs", torch.cat([x, skips[i]], 1), unet.DEPTH)
        return x

    def gaussian(self, p, bufs, net: str, x: torch.Tensor, train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma), each (B, latent_dim), of the prior or posterior net."""
        for i in range(len(self.f)):
            if i:
                x = ops.avg_pool(x)
            x = ops.conv_bn_relu_seq(p, bufs, f"{net}.encoder.block{i}", x, ENCODER_DEPTH, train)
        out = x.mean((2, 3)) @ p[f"{net}.head_kernel"].flatten(1).t() + p[f"{net}.head_bias"]
        mu, log_sigma = out.chunk(2, dim=1)
        return mu, torch.exp(log_sigma)

    def fcomb(self, p, bufs, feat: torch.Tensor, z: torch.Tensor, train: bool) -> torch.Tensor:
        """Logits (B, C, H, W) of the features with z (B, latent_dim)."""
        x = torch.cat([feat, z[:, :, None, None].expand(-1, -1, *feat.shape[2:])], 1)
        for i in range(self.fcomb_depth):
            x = ops.conv(p, f"fcomb.fc{i}.conv", x, bias_grad=False)
            x = torch.relu(ops.batch_norm(p, bufs, f"fcomb.fc{i}.bn", x, train))
        return ops.conv(p, "fcomb.last", x)

    def step_loss(self, p, bufs, x, mask, z_eps=None, train: bool = True) -> Dict[str, torch.Tensor]:
        """The loss terms of a batch x (B, 1, H, W), mask (B, H, W) int;
        ``z_eps`` (B, latent_dim) is the posterior's noise (absent: zero).
        ``bufs`` takes the running statistics' moves in train mode."""
        onehot = F.one_hot(mask.long(), self.C).permute(0, 3, 1, 2).to(x.dtype)
        prior_mu, prior_sigma = self.gaussian(p, bufs, "prior_net", x, train)
        post_mu, post_sigma = self.gaussian(p, bufs, "posterior_net", torch.cat([x, onehot - 0.5], 1), train)
        if z_eps is None:
            z_eps = torch.zeros_like(post_mu)
        logits = self.fcomb(p, bufs, self.features(p, x), post_mu + post_sigma * z_eps, train)
        recon = ops.pixel_ce(logits, mask).reshape(mask.shape[0], -1).sum(1).mean()
        kl = ops.kl_diag(post_mu, post_sigma, prior_mu, prior_sigma)
        reg = sum(torch.sqrt(t.square().sum() + NORM_EPS) for t in self.regularized(p))
        untouched = (p["last_conv.conv.weight"].sum() + p["last_conv.conv.bias"].sum()) * 0.0
        return {"loss": recon + kl + REG_WEIGHT * reg + untouched, "kl": kl, "recon": recon}

    def sample(self, p, bufs, x, n: int, eps=None) -> torch.Tensor:
        """The logits (n, C, H, W) of n prior samples of one image x (1, 1,
        H, W), eps (1, n, latent_dim) (absent: zero), in eval mode: the
        prior and the trunk once, fcomb on the n samples."""
        mu, sigma = self.gaussian(p, bufs, "prior_net", x, train=False)
        eps = torch.zeros((n, self.latent_dim), device=x.device) if eps is None else eps[0]
        feat = self.features(p, x).expand(n, -1, -1, -1)
        return self.fcomb(p, bufs, feat, mu + sigma * eps, train=False)


def build(exp: dict, overrides: Optional[dict] = None) -> Model:
    """The model of a configuration's ``experiment`` block."""
    e = {**exp, **(overrides or {})}
    if not e.get("kl_parity", True):
        raise NotImplementedError("the reference's KL is the published sigma1 * sigma0 form (kl_parity)")
    return Model(e["filter_channels"], e["latent_dim"], e["no_convs_fcomb"], e["n_classes"], e["image_size"],
                 e["input_channels"])
