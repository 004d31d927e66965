"""On-device 2D batch augmentation, the twin of ``unet_zoo_tpu.data.augment``.

Per image: a 1-in-``augment_every_nth`` gate coin; under it, a scale-crop
(square side r ~ U{n-offset..n}, top-left corner uniform, resized back) and a
rotation ~ U(-rot_degrees, rot_degrees) about the centre, composed into one
dst->src sampling grid; the image and the one-hot label are warped
bilinearly together in one pass, with a zero border, and the label comes
back by argmax; gate-off images pass through bit-exact; then left/right and
up/down flips, each with its own 1/max(2, augment_every_nth) coin, as exact
mirrors. The coordinate arithmetic follows the JAX package's op for op.

The work is split so that a test can inject the JAX package's draws:
``sample_augment_params`` draws every random number from an explicit
``torch.Generator`` on the device, and ``warp_batch_2d`` is deterministic.
``augment_batch_2d`` is the two together.

The JAX package warps with two tap-matrix matmuls, a workaround for slow
TPU gathers (``_gather_bilinear_mm``); here the 4 taps are gathered directly,
in plain PyTorch (the warp is not a Pallas kernel). Its arithmetic is exact
f32, the JAX package's ``warp_precision="highest"``. The elastic warp and
nearest-neighbour labels are not ported yet (ROADMAP, queue A item 3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentOptions:
    """2D augmentation switches, the JAX package's fields and defaults
    (without ``warp_precision``: the warp here is always exact f32)."""

    do_rotations: bool = False
    rot_degrees: float = 10.0
    do_scaleaug: bool = False
    offset: int = 30
    do_elasticaug: bool = False
    elastic_sigma: float = 10.0
    do_fliplr: bool = False
    do_flipud: bool = False
    augment_every_nth: int = 2
    nlabels: int = 2
    label_interp: str = "onehot_linear"  # or "nearest"

    @classmethod
    def from_dict(cls, d: Optional[dict], nlabels: int) -> "AugmentOptions":
        """Build from a reference-style options dict; both flip spellings
        (``do_fliplr`` and ``do_flip_lr``) are honoured, as in the JAX package."""
        if d is None:
            return cls(nlabels=nlabels)
        return cls(
            do_rotations=d.get("do_rotations", False),
            rot_degrees=d.get("rot_degrees", 10.0),
            do_scaleaug=d.get("do_scaleaug", False),
            offset=d.get("offset", 30),
            do_elasticaug=d.get("do_elasticaug", False),
            elastic_sigma=d.get("sigma", 10.0),
            do_fliplr=d.get("do_fliplr", d.get("do_flip_lr", False)),
            do_flipud=d.get("do_flipud", d.get("do_flip_ud", False)),
            augment_every_nth=d.get("augment_every_nth", 2),
            nlabels=d.get("nlabels", nlabels),
        )


class AugmentParams(NamedTuple):
    """One batch's draws, each of shape (B,). Every field is drawn whatever
    the options, as the JAX package splits all 8 keys of each image."""

    gate: torch.Tensor  # bool: warp this image
    angle: torch.Tensor  # float32 degrees
    r: torch.Tensor  # int64 crop side
    off_r: torch.Tensor  # int64 crop top row
    off_c: torch.Tensor  # int64 crop left column
    flip_lr: torch.Tensor  # bool
    flip_ud: torch.Tensor  # bool


def _check(opts: AugmentOptions) -> None:
    if opts.do_elasticaug:
        raise NotImplementedError(
            "do_elasticaug is not ported yet (ROADMAP, queue A item 3: its bicubic field "
            "must reproduce jax.image.resize's Keys kernel)")
    if opts.label_interp != "onehot_linear" or opts.nlabels > 4:
        raise NotImplementedError(
            "nearest-neighbour label warping (label_interp='nearest' or more than 4 labels) "
            "is not ported yet (ROADMAP, queue A item 3)")


def sample_augment_params(generator: torch.Generator, batch: int, size: Tuple[int, int],
                          opts: AugmentOptions, device=None) -> AugmentParams:
    """Draw the parameters of ``batch`` images of spatial ``size`` = (H, W),
    with the JAX package's ranges, from ``generator`` (which lives on
    ``device``). Integers are uniform over inclusive-exclusive ranges, as
    ``jax.random.randint``; each crop offset's range depends on its own r."""
    nh, nw = size

    def uniform() -> torch.Tensor:
        return torch.rand(batch, generator=generator, device=device)

    def randint(lo, hi) -> torch.Tensor:
        # u * n can round up to n in f32, hence the clamp
        n = hi - lo
        return lo + (uniform() * n).long().clamp(max=n - 1)

    p_flip = max(2, opts.augment_every_nth)
    gate = randint(0, opts.augment_every_nth) == 0
    angle = (2 * uniform() - 1) * opts.rot_degrees
    r = randint(nh - opts.offset, nh + 1)
    off_r = randint(0, nh - r + 1)
    off_c = randint(0, nw - r + 1)
    flip_lr = randint(0, p_flip) == 0
    flip_ud = randint(0, p_flip) == 0
    return AugmentParams(gate, angle, r, off_r, off_c, flip_lr, flip_ud)


def _source_coords(params: AugmentParams, size: Tuple[int, int], opts: AugmentOptions):
    """dst->src (rows, cols), each (B, H, W) float32: the base grid, then the
    scale-crop, then the rotation (``unet_zoo_tpu/data/augment.py``
    ``_apply_scale_crop``, ``_apply_rotation``), in the same f32 operations.
    Gate-off images are selected around the warp, so their parameters need
    no gating here."""
    nh, nw = size
    device = params.angle.device
    rows = torch.arange(nh, dtype=torch.float32, device=device).view(1, nh, 1).expand(-1, nh, nw)
    cols = torch.arange(nw, dtype=torch.float32, device=device).view(1, 1, nw).expand(-1, nh, nw)
    if opts.do_scaleaug:
        scale = params.r.float().view(-1, 1, 1)
        rows = (rows + 0.5) * (scale / nh) - 0.5 + params.off_r.float().view(-1, 1, 1)
        cols = (cols + 0.5) * (scale / nw) - 0.5 + params.off_c.float().view(-1, 1, 1)
    if opts.do_rotations:
        cy, cx = (nh - 1) / 2.0, (nw - 1) / 2.0
        t = torch.deg2rad(params.angle).view(-1, 1, 1)
        c, s = torch.cos(t), torch.sin(t)
        ry, rx = rows - cy, cols - cx
        rows = (s * rx + c * ry) + cy
        cols = (c * rx - s * ry) + cx
    return rows, cols


def _gather_bilinear(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) float32 at (B, H', W') coords, bilinear; a tap
    outside the image contributes 0 (``_tap_weights``'s zero border). Rows
    are interpolated first, then columns, the order of the JAX package's two
    contractions."""
    b, h, w, c = img.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()
    flat = img.reshape(b, h * w, c)

    def tap(r, col):
        valid = (r >= 0) & (r < h) & (col >= 0) & (col < w)
        idx = (r.clamp(0, h - 1) * w + col.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(*rows.shape, c)
        return torch.where(valid.unsqueeze(-1), v, 0.0)

    fr, fc = fr.unsqueeze(-1), fc.unsqueeze(-1)
    left = (1 - fr) * tap(r0, c0) + fr * tap(r0 + 1, c0)
    right = (1 - fr) * tap(r0, c0 + 1) + fr * tap(r0 + 1, c0 + 1)
    return (1 - fc) * left + fc * right


def _flip(x: torch.Tensor, coin: torch.Tensor, dim: int) -> torch.Tensor:
    coin = coin.view(-1, *([1] * (x.ndim - 1)))
    return torch.where(coin, x.flip(dim), x)


def warp_batch_2d(images: torch.Tensor, labels: torch.Tensor, params: AugmentParams,
                  opts: AugmentOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``params`` to images (B, H, W, C) float and labels (B, H, W)
    int; returns tensors of the same shapes and dtypes, on the same device."""
    _check(opts)
    size = tuple(images.shape[1:3])
    if opts.do_rotations or opts.do_scaleaug:
        rows, cols = _source_coords(params, size, opts)
        c = images.shape[-1]
        onehot = F.one_hot(labels.long(), opts.nlabels).float()
        warped = _gather_bilinear(torch.cat([images.float(), onehot], -1), rows, cols)
        w_img = warped[..., :c].to(images.dtype)
        w_lbl = warped[..., c:].argmax(-1).to(labels.dtype)
        gate = params.gate.view(-1, 1, 1)
        images = torch.where(gate.unsqueeze(-1), w_img, images)
        labels = torch.where(gate, w_lbl, labels)
    if opts.do_fliplr:
        images, labels = _flip(images, params.flip_lr, 2), _flip(labels, params.flip_lr, 2)
    if opts.do_flipud:
        images, labels = _flip(images, params.flip_ud, 1), _flip(labels, params.flip_ud, 1)
    return images, labels


def augment_batch_2d(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                     opts: AugmentOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw a batch's parameters from ``generator`` and warp: images
    (B, H, W, C) float, labels (B, H, W) int."""
    _check(opts)
    params = sample_augment_params(generator, images.shape[0], tuple(images.shape[1:3]), opts,
                                   images.device)
    return warp_batch_2d(images, labels, params, opts)
