"""PHiSeg (Baumgartner et al., MICCAI 2019, arXiv:1906.04045), the reference.

Written from the published model (gigantenbein/UNet-Zoo ``models/phiseg.py``
and its experiments ``phiseg_7_5_<bs>.py``) on NCHW float32 tensors:

* posterior and prior nets, each a pyramid of ``len(filters)`` levels of 3
  conv + BatchNorm + ReLU (a 2x2 average pool before each but the first;
  the posterior sees ``one_hot(mask) - 0.5`` beside the image), then
  ``latent_levels`` latent levels from the coarsest: level i > 0 resizes the
  coarser z to its skip (bilinear, corners aligned), runs 2 conv + BN +
  ReLU to ``2 * filters[0]`` channels and concatenates the skip; each
  level's 2 conv + BN + ReLU then 1x1 ``mu`` and softplus 1x1 ``sigma``;
* the likelihood: each level's z embedded (2 conv + BN + ReLU), brought up
  ``len(filters) - latent_levels`` resolution levels (resize, 1 conv + BN +
  ReLU), combined coarse to fine (resize the coarser, concatenate, 2 conv +
  BN + ReLU), a 1x1 head a level nearest-upsampled to the image;
* the loss: the cross-entropy of the logits summed coarse to fine, at each
  level, plus the 4^level-weighted KL of posterior and prior.

In training the prior is teacher-forced by the posterior's z and the
likelihood decodes the posterior's z; in evaluation every BatchNorm uses its
running statistics and the likelihood decodes the prior's z.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import ops

KL_LEVEL_WEIGHT = 4.0
TRUNK_DEPTH = 3

# the benchmark's tests' size: three resolution levels, two latent levels, 16x16
TINY = dict(filter_channels=(4, 8, 8), latent_levels=2, image_size=(16, 16))


class Model:
    """The sizes of one configuration: ``filters``, ``latent_levels``,
    ``zdim``, ``classes``, ``image_size``, ``in_channels``."""

    def __init__(self, filters: Sequence[int], latent_levels: int, zdim: int, classes: int,
                 image_size: Sequence[int], in_channels: int = 1):
        self.f = tuple(filters)
        self.R, self.L = len(self.f), latent_levels
        self.zdim, self.C = zdim, classes
        self.image_size = tuple(image_size)
        self.in_channels = in_channels
        self.sizes = [self.image_size]  # spatial size a resolution level, halved with ceil
        for _ in range(self.R - 1):
            self.sizes.append(tuple(-(-s // 2) for s in self.sizes[-1]))

    # parameters

    def specs(self) -> List[Tuple[str, tuple, tuple]]:
        """(path, shape, init) of every parameter and buffer. Inits:
        ("uniform", bound), ("const", value)."""
        out = []

        def conv(name, ci, co, k):
            bound = 1.0 / (ci * k * k) ** 0.5
            out.append((f"{name}.weight", (co, ci, k, k), ("uniform", bound)))
            out.append((f"{name}.bias", (co,), ("uniform", bound)))

        def seq(name, ci, co, depth):
            for i in range(depth):
                conv(f"{name}.conv{i}.conv", ci if i == 0 else co, co, 3)
                for leaf, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
                    out.append((f"{name}.conv{i}.bn.{leaf}", (co,), ("const", v)))

        f, R, L, z = self.f, self.R, self.L, self.zdim
        for net, c in (("posterior", self.in_channels + self.C), ("prior", self.in_channels)):
            for i, fi in enumerate(f):
                seq(f"{net}.down{i}.convs", c, fi, TRUNK_DEPTH)
                c = fi
            for i in range(L - 1):
                seq(f"{net}.up{i}.convs", z, 2 * f[0], 2)
            for i in range(L):
                c = f[-1] if i == 0 else 2 * f[0] + f[R - 1 - i]
                seq(f"{net}.samplez{i}.convs", c, c, 2)
                conv(f"{net}.samplez{i}.mu", c, z, 1)
                conv(f"{net}.samplez{i}.sigma", c, z, 1)
        diff = R - L
        for j in range(L):
            feats = f[L - 1 - j]
            seq(f"likelihood.embed{j}", z, feats, 2)
            for t in range(diff):
                seq(f"likelihood.incres{j}_{t}", feats, feats, 1)
        for i in range(L - 1):
            seq(f"likelihood.postc{i}", f[i] + self._post_c_channels(i + 1), f[i + diff], 2)
        for j in range(L):
            conv(f"likelihood.head{j}.conv", self._post_c_channels(L - 1 - j), self.C, 1)
        return out

    def _post_c_channels(self, i: int) -> int:
        return self.f[self.L - 1] if i == self.L - 1 else self.f[i + self.R - self.L]

    def latent_sizes(self) -> List[tuple]:
        """Spatial size of each latent level, finest (level 0) first."""
        return [self.sizes[lvl + self.R - self.L] for lvl in range(self.L)]

    # the noise: channels last in the program, (..., zdim, h, w) here

    def noise_shapes(self, batch: int) -> List[tuple]:
        """A train step's posterior noise as the program's ``train_step``
        takes its ``z_eps``: (batch, h, w, zdim) a latent level, finest
        first."""
        return [(batch, *s, self.zdim) for s in self.latent_sizes()]

    def image_noise_shapes(self, samples: int, n_loss: int) -> tuple:
        """An evaluated image's noise as the program's ``eval_image`` takes
        it: ``eps``, (1, samples, h, w, zdim) a level, for the samples, then
        ``loss_eps``, the (posterior, prior) pair of (n_loss, h, w, zdim)
        levels, for the eval-mode loss."""
        levels = self.latent_sizes()
        loss = [(n_loss, *s, self.zdim) for s in levels]
        return [(1, samples, *s, self.zdim) for s in levels], (loss, loss)

    def to_reference(self, eps):
        """Noise of ``noise_shapes`` or of either part of
        ``image_noise_shapes``, in the layout that ``step_loss`` and
        ``sample`` take: each level's zdim moved before its h and w."""
        if isinstance(eps, tuple):
            return tuple(self.to_reference(e) for e in eps)
        return [e.movedim(-1, -3) for e in eps]

    # the nets

    def _encoder(self, p, bufs, net: str, x, train: bool) -> Tuple[list, torch.Tensor]:
        skips = []
        for i in range(self.R):
            if i:
                x = ops.avg_pool(x)
            x = ops.conv_bn_relu_seq(p, bufs, f"{net}.down{i}.convs", x, TRUNK_DEPTH, train)
            if i != self.R - 1:
                skips.append(x)
        return skips, x

    def _zpath(self, p, bufs, net: str, skips, bottom, train: bool, teacher=None, eps=None):
        L = self.L
        z, mu, sigma = [None] * L, [None] * L, [None] * L
        pre = bottom
        for i in range(L):
            if i:
                skip = skips[-i]
                up = ops.resize(z[L - i], skip.shape[2:], align_corners=True)
                up = ops.conv_bn_relu_seq(p, bufs, f"{net}.up{i - 1}.convs", up, 2, train)
                pre = torch.cat([up, skip], 1)
            h = ops.conv_bn_relu_seq(p, bufs, f"{net}.samplez{i}.convs", pre, 2, train)
            lvl = L - 1 - i
            mu[lvl] = ops.conv(p, f"{net}.samplez{i}.mu", h)
            sigma[lvl] = F.softplus(ops.conv(p, f"{net}.samplez{i}.sigma", h))
            z[lvl] = teacher[lvl] if teacher is not None else mu[lvl] + sigma[lvl] * eps[lvl]
        return z, mu, sigma

    def _likelihood(self, p, bufs, z, train: bool) -> list:
        L, diff = self.L, self.R - self.L
        post_z = [None] * L
        for j in range(L):
            lvl = L - 1 - j
            h = ops.conv_bn_relu_seq(p, bufs, f"likelihood.embed{j}", z[lvl], 2, train)
            for t in range(diff):
                h = ops.resize(h, self.sizes[lvl + diff - 1 - t], align_corners=True)
                h = ops.conv_bn_relu_seq(p, bufs, f"likelihood.incres{j}_{t}", h, 1, train)
            post_z[lvl] = h
        post_c = [None] * L
        post_c[L - 1] = post_z[L - 1]
        for i in range(L - 2, -1, -1):
            ups = ops.resize(post_c[i + 1], post_z[i].shape[2:], align_corners=True)
            post_c[i] = ops.conv_bn_relu_seq(p, bufs, f"likelihood.postc{i}", torch.cat([post_z[i], ups], 1),
                                             2, train)
        s = [None] * L
        for j in range(L):
            lvl = L - 1 - j
            s[lvl] = ops.upsample_nearest(ops.conv(p, f"likelihood.head{j}.conv", post_c[lvl]), self.image_size)
        return s

    def forward(self, p, bufs, x, mask, train: bool, post_eps, prior_eps=None) -> Dict[str, list]:
        """x (B, 1, H, W), mask (B, H, W) int; eps lists (B, zdim, h, w) a
        latent level, finest first. ``bufs`` takes the running statistics'
        moves in train mode (None: leave them)."""
        onehot = F.one_hot(mask.long(), self.C).permute(0, 3, 1, 2).to(x.dtype)
        skips, bottom = self._encoder(p, bufs, "posterior", torch.cat([x, onehot - 0.5], 1), train)
        post = self._zpath(p, bufs, "posterior", skips, bottom, train, eps=post_eps)
        skips, bottom = self._encoder(p, bufs, "prior", x, train)
        prior = self._zpath(p, bufs, "prior", skips, bottom, train, teacher=post[0] if train else None,
                            eps=prior_eps)
        s = self._likelihood(p, bufs, post[0] if train else prior[0], train)
        return {"post_mu": post[1], "post_sigma": post[2], "prior_mu": prior[1], "prior_sigma": prior[2], "s": s}

    def loss(self, out, mask) -> Dict[str, torch.Tensor]:
        kl = 0.0
        for lvl in range(self.L):
            kl = kl + KL_LEVEL_WEIGHT ** lvl * ops.kl_diag(out["post_mu"][lvl], out["post_sigma"][lvl],
                                                           out["prior_mu"][lvl], out["prior_sigma"][lvl])
        s = out["s"]
        acc = s[self.L - 1]
        recon = _multinoulli(acc, mask)
        for lvl in range(self.L - 2, -1, -1):
            acc = acc + s[lvl]
            recon = recon + _multinoulli(acc, mask)
        return {"loss": kl + recon, "kl": kl, "recon": recon}

    def step_loss(self, p, bufs, x, mask, z_eps=None, train: bool = True) -> Dict[str, torch.Tensor]:
        """The loss terms of ``forward``. ``z_eps`` (``to_reference``'s
        layout) is the posterior's noise in training, and the (posterior,
        prior) pair in evaluation; absent noise is zero."""
        if train:
            post_eps, prior_eps = z_eps, None
        else:
            post_eps, prior_eps = z_eps if z_eps is not None else (None, None)
        if post_eps is None:
            post_eps = self._zeros(x)
        if not train and prior_eps is None:
            prior_eps = self._zeros(x)
        return self.loss(self.forward(p, bufs, x, mask, train, post_eps, prior_eps), mask)

    def _zeros(self, x) -> list:
        return [torch.zeros((x.shape[0], self.zdim, *s), device=x.device) for s in self.latent_sizes()]

    def sample(self, p, bufs, x, n: int, eps=None) -> torch.Tensor:
        """The logits (n, C, H, W) of n prior samples of one image x (1, 1, H,
        W), eps (1, n, zdim, h, w) a latent level (absent: zero): the prior's
        trunk once, its latent path and the likelihood on the samples, all in
        eval mode."""
        if eps is None:
            eps = [torch.zeros((n, self.zdim, *s), device=x.device) for s in self.latent_sizes()]
        else:
            eps = [e[0] for e in eps]
        skips, bottom = self._encoder(p, bufs, "prior", x, train=False)
        skips = [t.expand(n, -1, -1, -1) for t in skips[len(skips) - (self.L - 1):]]
        z, _, _ = self._zpath(p, bufs, "prior", skips, bottom.expand(n, -1, -1, -1), False, eps=eps)
        s = self._likelihood(p, bufs, z, False)
        total = s[0]
        for t in s[1:]:
            total = total + t
        return total


def build(exp: dict, overrides: Optional[dict] = None) -> Model:
    """The model of a configuration's ``experiment`` block."""
    e = {**exp, **(overrides or {})}
    return Model(e["filter_channels"], e["latent_levels"], e["zdim"], e["n_classes"], e["image_size"],
                 e["input_channels"])


def _multinoulli(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batch mean of the pixel-summed cross-entropy."""
    return ops.pixel_ce(logits, mask).reshape(mask.shape[0], -1).sum(1).mean()
