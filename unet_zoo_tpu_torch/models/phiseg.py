"""PHiSeg, the twin of ``unet_zoo_tpu.models.phiseg`` (2D NHWC and PHiSeg3D on NDHWC), in the
three memory modes.

A hierarchical conditional VAE for segmentation (arXiv:1906.04045):

* posterior and prior encoders (``_PhiEncoder``, the same net, the posterior
  with ``one_hot(mask) - 0.5`` concatenated to the image): a contracting
  pyramid of conv + BatchNorm + ReLU blocks (``trunk``), then a coarse-to-fine
  latent path (``zpath``): ``_SampleZ`` at the coarsest level, and at each
  finer level an up block on the previous level's z beside the skip;
* the likelihood (``_PhiLikelihood``): each level's z embedded and brought up
  ``lvl_diff`` resolution levels, a top-down concat-and-refine path, and 1x1
  heads nearest-upsampled to the image, giving residual logits that
  accumulate coarse to fine;
* the loss: the residual multinoulli CE on the cumulative logits plus the
  4^level-weighted hierarchical KL (``kl_parity``: the reference's
  ``sigma1 * sigma0`` quirk).

One class serves both ranks, as in the JAX package: ``len(image_size)`` (2
or 3) sets the number of spatial axes, and every resize targets the shape's
spatial part (``shape[1:-1]``). The registry's ``phiseg3d`` is this class
with ``REV_DEPTHS_3D``.

``self.training`` stands where the JAX package passes ``train``: it selects
BatchNorm's batch statistics, the prior's teacher forcing by the posterior z
and which z the likelihood decodes (the posterior's in training, else the
prior's). Every BN sequence runs as library ops: the JAX package's BN
sequences never reach its Pallas kernel either.

Randomness: every z noise can be passed in (``post_eps``/``prior_eps`` of
``forward``, ``eps`` of ``sample``), one tensor per latent level; otherwise
it is drawn from ``generator``, by default the model's own device generator
(``self.generator``).

Cast points (bf16 ``dtype``) as in the JAX package: the posterior's input is
the float32 concat, cast by the first conv; BN outputs the conv's dtype;
``mu``/``sigma`` 1x1 convs run in their input's dtype, then float32, with
softplus in float32; z is cast to the skip's dtype before an up block's
resize and to ``dtype or float32`` before each embed; the heads take no
dtype, so the logits and their accumulation are bf16 and the CE is float32.
A tuple input is concatenated before its conv (the JAX package splits the
kernel instead).

Memory modes (``reversible_mode``), as in the JAX model: "remat" runs every
conv sequence under ``ops.remat`` with the plain parameter tree;
"reversible" (RevPHiSeg) makes the down blocks, the up blocks, the
``_SampleZ`` sequences, the likelihood's embeds and its post-c sequences
``ReversibleSequence``s of ``rev_depths`` = (down, up, sample_z, embed,
post_c) coupling blocks (``REV_DEPTHS_2D``, or ``REV_DEPTHS_3D`` for
PHiSeg3D). In both memory modes the likelihood's
resolution-increase stages, which sit at the largest sizes, run under
``ops.remat`` with their plain parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.models.blocks import PhiDownBlock, seq_name
from unet_zoo_tpu_torch.models.prob_unet import kl_two_gauss_diag
from unet_zoo_tpu_torch.models.unet import softmax_cross_entropy
from unet_zoo_tpu_torch.parallel import space

Levels = List[torch.Tensor]

# the weight of level l's KL term is EXPONENTIAL_WEIGHT ** l with exponential_weighting
EXPONENTIAL_WEIGHT = 4.0

# coupling blocks of each reversible sequence kind: (down, up, sample_z, embed, post_c)
REV_DEPTHS_2D = (3, 2, 3, 2, 2)
REV_DEPTHS_3D = (1, 1, 1, 1, 1)


def _seq(in_channels: int, features: int, depth: int, mode: str = "plain", rev_depth: Optional[int] = None,
         **kw) -> nn.Module:
    return ops.conv_sequence(in_channels, features, depth, mode=mode, rev_depth=rev_depth, norm=True,
                             init_scheme="torch_default", **kw)


class _SampleZ(nn.Module):
    """2 conv+BN+ReLU (or ``rev_depth`` coupling blocks), then 1x1 ``mu``
    and softplus 1x1 ``sigma`` heads."""

    def __init__(self, in_channels: int, zdim: int, mode: str = "plain", rev_depth: int = REV_DEPTHS_2D[2],
                 dtype=None, device=None, generator=None, ndim: int = 2):
        super().__init__()
        self.seq_name = seq_name(mode)
        self.add_module(self.seq_name, _seq(in_channels, in_channels, 2, mode, rev_depth, dtype=dtype,
                                            device=device, generator=generator, ndim=ndim))
        self.mu = ops.Conv(in_channels, zdim, kernel_size=1, device=device, generator=generator, ndim=ndim)
        self.sigma = ops.Conv(in_channels, zdim, kernel_size=1, device=device, generator=generator, ndim=ndim)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = getattr(self, self.seq_name)(x)
        return self.mu(x).float(), F.softplus(self.sigma(x).float())


class _PhiUpBlock(nn.Module):
    """z resized (bi- or trilinear, ``align_corners=True``) to the skip's
    exact shape, 2 conv+BN+ReLU (or ``rev_depth`` coupling blocks), returned
    beside the skip as an implicit concat."""

    def __init__(self, zdim: int, features: int, mode: str = "plain", rev_depth: int = REV_DEPTHS_2D[1],
                 dtype=None, device=None, generator=None, ndim: int = 2):
        super().__init__()
        self.seq_name = seq_name(mode)
        self.add_module(self.seq_name, _seq(zdim, features, 2, mode, rev_depth, dtype=dtype, device=device,
                                            generator=generator, ndim=ndim))

    def forward(self, z: torch.Tensor, bridge: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = ops.resize_linear(z.to(bridge.dtype), space.global_spatial(bridge), align_corners=True)
        return getattr(self, self.seq_name)(x), bridge


class _PhiEncoder(nn.Module):
    """The posterior (``is_posterior``: the mask joins the image) or the prior net."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], latent_levels: int, is_posterior: bool,
                 mask_channels: int = 2, zdim: int = 2, reversible_mode: str = "plain",
                 rev_depths: Sequence[int] = REV_DEPTHS_2D, dtype=None, device=None, generator=None, ndim: int = 2):
        super().__init__()
        R, L = len(num_filters), latent_levels
        self.is_posterior = is_posterior
        self.mask_channels = mask_channels
        self.latent_levels = L
        self.zdim = zdim
        kw = dict(dtype=dtype, device=device, generator=generator, ndim=ndim)
        mode = reversible_mode
        c = in_channels + (mask_channels if is_posterior else 0)
        for i, f in enumerate(num_filters):
            self.add_module(f"down{i}", PhiDownBlock(c, f, pool=i != 0, reversible_mode=mode,
                                                     rev_depth=rev_depths[0], **kw))
            c = f
        for i in range(L - 1):
            self.add_module(f"up{i}", _PhiUpBlock(zdim, 2 * num_filters[0], mode, rev_depths[1], **kw))
        for i in range(L):
            c = num_filters[-1] if i == 0 else 2 * num_filters[0] + num_filters[R - 1 - i]
            self.add_module(f"samplez{i}", _SampleZ(c, zdim, mode, rev_depths[2], **kw))
        self.num_levels = R

    def trunk(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tuple[Levels, torch.Tensor]:
        """The contracting pyramid: (skips, bottom)."""
        if self.is_posterior:
            if mask is None:
                raise ValueError("the posterior needs the mask")
            if mask.ndim == x.ndim:  # already one-hot
                oh = mask.to(x.dtype)
            else:
                oh = F.one_hot(mask.long(), self.mask_channels).to(x.dtype)
            x = torch.cat([x, oh - 0.5], dim=-1)
        skips = []
        for i in range(self.num_levels):
            x = getattr(self, f"down{i}")(x)
            if i != self.num_levels - 1:
                skips.append(x)
        return skips, x

    def zpath(self, skips: Levels, bottom: torch.Tensor, teacher_z: Optional[Levels] = None,
              eps: Optional[Levels] = None, generator: Optional[torch.Generator] = None
              ) -> Tuple[Levels, Levels, Levels]:
        """Coarse-to-fine latents: (z, mu, sigma), each indexed by level (0
        finest). ``teacher_z`` replaces each level's z (the prior in
        training); otherwise z = mu + sigma * eps, with ``eps[lvl]`` given or
        drawn from ``generator``."""
        L = self.latent_levels
        z: List = [None] * L
        mu: List = [None] * L
        sigma: List = [None] * L
        pre = bottom
        for i in range(L):  # i = 0: the coarsest latent, level L - 1
            if i != 0:
                pre = getattr(self, f"up{i - 1}")(z[L - i], skips[-i])
            lvl = L - 1 - i
            mu[lvl], sigma[lvl] = getattr(self, f"samplez{i}")(pre)
            if teacher_z is not None:
                z[lvl] = teacher_z[lvl]
            else:
                if eps is None and space.current() is not None:
                    raise ValueError("under spatial sharding the z noise is given (the global batch's rows: "
                                     "Trainer.forward_loss), never drawn on a process's own rows")
                e = eps[lvl] if eps is not None else torch.randn(
                    sigma[lvl].shape, generator=generator, device=sigma[lvl].device)
                z[lvl] = mu[lvl] + sigma[lvl] * e
        return z, mu, sigma

    def forward(self, x, mask=None, teacher_z=None, eps=None, generator=None):
        skips, bottom = self.trunk(x, mask)
        return self.zpath(skips, bottom, teacher_z, eps, generator)


class _PhiLikelihood(nn.Module):
    """Decodes the latent hierarchy into per-level residual logits."""

    def __init__(self, num_classes: int, num_filters: Sequence[int], latent_levels: int,
                 image_size: Sequence[int], zdim: int = 2, reversible_mode: str = "plain",
                 rev_depths: Sequence[int] = REV_DEPTHS_2D, dtype=None, device=None, generator=None, ndim: int = 2):
        super().__init__()
        R, L = len(num_filters), latent_levels
        self.num_filters = tuple(num_filters)
        self.latent_levels = L
        self.image_size = tuple(image_size)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator, ndim=ndim)
        mode = reversible_mode
        # the resolution-increase stages stay conv sequences, under remat in both memory modes
        incres_mode = "plain" if mode == "plain" else "remat"
        lvl_diff = R - L
        for j in range(L):  # the j-th embed handles latent level L - 1 - j
            feats = num_filters[L - 1 - j]
            self.add_module(f"embed{j}", _seq(zdim, feats, 2, mode, rev_depths[3], **kw))
            for t in range(lvl_diff):
                self.add_module(f"incres{j}_{t}", _seq(feats, feats, 1, incres_mode, **kw))

        def post_c_channels(i: int) -> int:
            return num_filters[L - 1] if i == L - 1 else num_filters[i + lvl_diff]

        for i in range(L - 1):
            self.add_module(f"postc{i}", _seq(num_filters[i] + post_c_channels(i + 1),
                                              num_filters[i + lvl_diff], 2, mode, rev_depths[4], **kw))
        for j in range(L):
            self.add_module(f"head{j}", ops.ConvBNAct(
                post_c_channels(L - 1 - j), num_classes, kernel_size=1, norm=False, act=False,
                device=device, generator=generator, ndim=ndim))

    def forward(self, z_list: Levels) -> Levels:
        L, R = self.latent_levels, len(self.num_filters)
        lvl_diff = R - L
        # the encoder's ceil-halving sizes, so odd pyramids decode to the skips' shapes
        chain = [self.image_size]
        for _ in range(R - 1):
            chain.append(tuple(-(-s // 2) for s in chain[-1]))

        post_z: List = [None] * L
        for j in range(L):
            lvl = L - 1 - j
            h = getattr(self, f"embed{j}")(z_list[lvl].to(self.dtype or torch.float32))
            for t in range(lvl_diff):
                h = ops.resize_linear(h, chain[lvl + lvl_diff - 1 - t], align_corners=True)
                h = getattr(self, f"incres{j}_{t}")(h)
            post_z[lvl] = h

        post_c: List = [None] * L
        post_c[L - 1] = post_z[L - 1]
        for i in range(L - 2, -1, -1):
            ups = ops.resize_linear(post_c[i + 1], space.global_spatial(post_z[i]), align_corners=True)
            post_c[i] = getattr(self, f"postc{i}")((post_z[i], ups))

        s: List = [None] * L
        for j in range(L):
            lvl = L - 1 - j
            s[lvl] = ops.upsample_nearest(getattr(self, f"head{j}")(post_c[lvl]), self.image_size)
        return s


class PHiSeg(nn.Module):
    """PHiSeg on NHWC input, or PHiSeg3D on NDHWC input where ``image_size``
    has 3 axes. ``in_channels`` is explicit here (the JAX model infers it at
    init)."""

    def __init__(self, num_classes: int, num_filters: Sequence[int] = (32, 64, 128, 192, 192, 192, 192),
                 latent_levels: int = 5, zdim: int = 2, image_size: Sequence[int] = (128, 128),
                 in_channels: int = 1, reversible_mode: str = "plain", exponential_weighting: bool = True,
                 kl_parity: bool = True, rev_depths: Sequence[int] = REV_DEPTHS_2D,
                 dtype: Optional[torch.dtype] = None, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= latent_levels <= len(num_filters):
            raise ValueError(f"latent_levels must be in [1, {len(num_filters)}], got {latent_levels}")
        if len(image_size) not in (2, 3) or len(rev_depths) != 5:
            raise ValueError(f"PHiSeg takes a 2D or 3D image_size and 5 rev_depths, got {tuple(image_size)} and "
                             f"{tuple(rev_depths)}")
        self.latent_levels = latent_levels
        self.exponential_weighting = exponential_weighting
        self.kl_parity = kl_parity
        kw = dict(num_filters=tuple(num_filters), latent_levels=latent_levels, zdim=zdim,
                  reversible_mode=reversible_mode, rev_depths=tuple(rev_depths), dtype=dtype, device=device,
                  generator=generator, ndim=len(image_size))
        self.posterior = _PhiEncoder(in_channels, is_posterior=True, mask_channels=num_classes, **kw)
        self.prior = _PhiEncoder(in_channels, is_posterior=False, **kw)
        self.likelihood = _PhiLikelihood(num_classes, image_size=image_size, **kw)
        # the default source of z noise, seeded from the weights' generator
        seed = int(torch.randint(2 ** 62, (1,), generator=generator).item())
        self.generator = torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                post_eps: Optional[Levels] = None, prior_eps: Optional[Levels] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Levels]:
        """x (B, *S, C); mask (B, *S) int or (B, *S, classes) one-hot (BraTS).
        Returns the posterior's (if ``mask``) and the prior's z, mu and sigma
        and ``s_list``, each a list indexed by latent level. In training the
        prior is teacher-forced by the posterior z (so ``prior_eps`` is not
        used) and the posterior z is decoded."""
        generator = generator or self.generator
        out: Dict[str, Levels] = {}
        if mask is not None:
            out["post_z"], out["post_mu"], out["post_sigma"] = self.posterior(
                x, mask, eps=post_eps, generator=generator)
        teacher = out["post_z"] if self.training and mask is not None else None
        out["prior_z"], out["prior_mu"], out["prior_sigma"] = self.prior(
            x, None, teacher, eps=prior_eps, generator=generator)
        out["s_list"] = self.likelihood(out["post_z"] if teacher is not None else out["prior_z"])
        return out

    def train_noise(self, batch: int, spatial: Sequence[int], generator: torch.Generator, device) -> Levels:
        """The posterior's z noise of a train-mode ``forward`` on a batch of
        ``batch`` images of ``spatial`` size, drawn from ``generator`` as
        the forward draws it: one (batch, *s, zdim) tensor a latent level,
        the coarsest first (level L - 1 at the encoder's last resolution,
        each finer one a resolution up; the encoder halves with ceil).
        Returned indexed by level, as ``post_eps``."""
        R, L = self.posterior.num_levels, self.latent_levels
        sizes = [tuple(spatial)]
        for _ in range(R - 1):
            sizes.append(tuple(-(-s // 2) for s in sizes[-1]))
        eps = [torch.randn((batch, *sizes[lvl + R - L], self.posterior.zdim), generator=generator, device=device)
               for lvl in range(L - 1, -1, -1)]
        return eps[::-1]

    def sample(self, x: torch.Tensor, n: int, eps: Optional[Levels] = None,
               generator: Optional[torch.Generator] = None, chunk: Optional[int] = None) -> torch.Tensor:
        """n prior samples, with BatchNorm's running statistics whatever the
        mode: the trunk runs once, the latent path and the decoder on the n *
        B samples folded into the batch, sample-major, ``chunk`` samples at a
        time (default all n). ``eps[lvl]`` is (B, n, *s, zdim); otherwise the
        noise of the whole fold is drawn from ``generator`` before the first
        chunk, level by level from the coarsest, as the latent path would
        draw it, so that a chunked fold decodes what the whole fold does.
        Returns the accumulated logits (B, n, *S, classes)."""
        generator = generator or self.generator
        was_training = self.training
        self.eval()
        try:
            skips, bottom = self.prior.trunk(x)
            batch, L = x.shape[0], self.latent_levels
            skips = skips[len(skips) - (L - 1):]  # the latent path reads the coarsest L - 1 skips only
            if eps is None:
                # level L - 1 - i comes from the bottom (i = 0) or from skips[-i]
                spatial = [bottom.shape[1:-1]] + [skips[-i].shape[1:-1] for i in range(1, L)]
                eps = [torch.randn((n * batch, *s, self.prior.zdim), generator=generator, device=x.device)
                       for s in spatial][::-1]
            else:
                eps = [e.transpose(0, 1).reshape(n * batch, *e.shape[2:]) for e in eps]
            chunk = chunk or n
            logits = []
            for s0 in range(0, n, chunk):
                c = min(chunk, n - s0)
                fold = [t.repeat(c, *([1] * (t.ndim - 1))) for t in (*skips, bottom)]
                rows = slice(s0 * batch, (s0 + c) * batch)
                z, _, _ = self.prior.zpath(fold[:-1], fold[-1], eps=[e[rows] for e in eps])
                logits.append(self.accumulate_output(self.likelihood(z)))
            logits = torch.cat(logits)
        finally:
            self.train(was_training)
        return logits.reshape(n, batch, *logits.shape[1:]).transpose(0, 1)

    # the loss (reference phiseg.py:455-513)

    def loss(self, out: Dict[str, Levels], mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        kl = self.hierarchical_kl(out["post_mu"], out["post_sigma"], out["prior_mu"], out["prior_sigma"])
        recon = self.residual_multinoulli(out["s_list"], mask)
        loss = kl + recon
        return loss, {"loss": loss, "kl": kl, "recon": recon}

    def hierarchical_kl(self, post_mu: Levels, post_sigma: Levels, prior_mu: Levels,
                        prior_sigma: Levels) -> torch.Tensor:
        """Sum over levels of w * KL, w = 4^level (the coarsest weighs most).
        Under spatial sharding each level's KL sums this process's pixels,
        and a replicated level's counts on one process (``space.own``)."""
        total = 0.0
        for lvl in range(self.latent_levels):
            w = EXPONENTIAL_WEIGHT ** lvl if self.exponential_weighting else 1.0
            total = total + w * kl_two_gauss_diag(post_mu[lvl], post_sigma[lvl], prior_mu[lvl],
                                                  prior_sigma[lvl], parity=self.kl_parity) * space.own(post_mu[lvl])
        return total

    def residual_multinoulli(self, s_list: Levels, mask: torch.Tensor) -> torch.Tensor:
        """CE of the cumulative coarse-to-fine logits, summed over levels; the
        logits accumulate in their own dtype."""
        L = self.latent_levels
        s_acc = s_list[L - 1]
        total = self._multinoulli(s_acc, mask)
        for lvl in range(L - 2, -1, -1):
            s_acc = s_acc + s_list[lvl]
            total = total + self._multinoulli(s_acc, mask)
        return total

    @staticmethod
    def _multinoulli(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Batch mean of the pixel-summed CE; integer or one-hot masks.
        Under spatial sharding the sum is over this process's pixels (and a
        replicated map's counts on one process, ``space.own``)."""
        if mask.ndim == logits.ndim:
            ce = -(mask.float() * F.log_softmax(logits.float(), dim=-1)).sum(-1)
        else:
            ce = softmax_cross_entropy(logits, mask)
        return ce.reshape(ce.shape[0], -1).sum(1).mean() * space.own(logits)

    @staticmethod
    def accumulate_output(s_list: Levels, use_softmax: bool = False) -> torch.Tensor:
        total = s_list[0]
        for s in s_list[1:]:
            total = total + s
        return torch.softmax(total, dim=-1) if use_softmax else total
