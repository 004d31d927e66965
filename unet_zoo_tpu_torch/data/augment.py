"""On-device batch augmentation, the twin of ``unet_zoo_tpu.data.augment``:
2D (``augment_batch_2d``) and 3D, for BraTS volumes (``augment_batch_3d``).

2D, per image: a 1-in-``augment_every_nth`` gate coin; under it, an elastic
displacement (a 3x3 N(0, sigma) field a coordinate axis, upsampled to the
image by ``jax.image.resize``'s cubic: ``elastic_field``), a scale-crop
(square side r ~ U{n-offset..n}, top-left corner uniform, resized back) and a
rotation ~ U(-rot_degrees, rot_degrees) about the centre, composed into one
dst->src sampling grid; the image and the one-hot label are warped
bilinearly together in one pass, with a zero border, and the label comes
back by argmax (more than 4 labels, or ``label_interp="nearest"``: the
label by its nearest source pixel, rounded half away from zero as
``map_coordinates(order=0)`` rounds); gate-off images pass through
bit-exact; then left/right and up/down flips, each with its own
1/max(2, augment_every_nth) coin, as exact mirrors.

3D, per volume (D, H, W, C), as the JAX package: one in-plane (H, W) grid,
shared by every D slice, from an elastic field, a scale s ~ U(1/f, f) (the
volume resized to round(n s) and centre-cropped or padded back) and a
rotation; the image and the one-hot WT/TC/ET labels are gathered
bilinearly in exact f32 in one pass, so the labels come back soft
(``onehot_labels``, the JAX package's default and BraTS's form; integer
labels by their nearest voxel); then a per-channel intensity shift
~ U(-m, m) and a flip of each of the three axes with its own fair coin.
Nothing is gated.

The coordinate arithmetic follows the JAX package's op for op. The work is
split so that a test can inject the JAX package's draws: the
``sample_*_params`` functions draw every random number from an explicit
``torch.Generator`` on the device, and the ``warp_*`` functions are
deterministic.

The JAX package warps 2D images with two tap-matrix matmuls, a workaround
for slow TPU gathers (``_gather_bilinear_mm``); here the 4 taps are
gathered directly, in plain PyTorch (the warp is not a Pallas kernel). Its
arithmetic is exact f32, the JAX package's ``warp_precision="highest"``.
The cubic field is ``jax.image.resize(..., "cubic")``'s own: Keys' kernel
with a = -0.5 at half-pixel centres, the taps outside the 3x3 grid dropped
and the rest renormalised (``_keys_cubic_matrix``), where torch's bicubic
takes a = -0.75 and clamps at the border.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LABEL_INTERPS = ("onehot_linear", "nearest")


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
    """One batch's draws, each of shape (B,) but ``field``. Every field is
    drawn whatever the options, as the JAX package splits all 8 keys of
    each image."""

    gate: torch.Tensor  # bool: warp this image
    angle: torch.Tensor  # float32 degrees
    r: torch.Tensor  # int64 crop side
    off_r: torch.Tensor  # int64 crop top row
    off_c: torch.Tensor  # int64 crop left column
    flip_lr: torch.Tensor  # bool
    flip_ud: torch.Tensor  # bool
    field: torch.Tensor  # float32 (B, 2, 3, 3): the coarse elastic field, sigma * N(0, 1), rows then cols


@dataclasses.dataclass(frozen=True)
class Augment3DOptions:
    """3D (BraTS) augmentation switches, the JAX package's fields and defaults."""

    do_rotate: bool = True
    rot_degrees: float = 20.0
    do_scale: bool = True
    scale_factor: float = 1.1
    do_elastic: bool = True
    elastic_sigma: float = 10.0
    do_flip: bool = True
    do_intensity_shift: bool = True
    max_intensity_shift: float = 0.1
    nlabels: int = 3
    onehot_labels: bool = True  # labels arrive one-hot (WT/TC/ET) and warp bilinearly into soft labels


class Augment3DParams(NamedTuple):
    """One batch's 3D draws."""

    angle: torch.Tensor  # (B,) float32 degrees
    scale: torch.Tensor  # (B,) float32 in-plane zoom
    field: torch.Tensor  # (B, 2, 3, 3) float32 coarse elastic field, sigma * N(0, 1)
    shift: torch.Tensor  # (B, C) float32 intensity shift a channel
    flip: torch.Tensor  # (B, 3) bool: flip D, H, W


def take_rows(params, rows: slice):
    """Rows ``rows`` of an ``AugmentParams`` or ``Augment3DParams``, whose
    every field is batch-leading: a data-parallel rank's share of the
    global batch's draws."""
    return type(params)(*(t[rows] for t in params))


def _check(opts: AugmentOptions) -> None:
    if opts.label_interp not in LABEL_INTERPS:
        raise ValueError(f"label_interp must be one of {LABEL_INTERPS}, got '{opts.label_interp}'")


def _uniform(generator: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """U(lo, hi) as ``jax.random.uniform(minval, maxval)`` maps its draw."""
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


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
    field = opts.elastic_sigma * torch.randn((batch, 2, 3, 3), generator=generator, device=device)
    return AugmentParams(gate, angle, r, off_r, off_c, flip_lr, flip_ud, field)


def sample_augment_3d_params(generator: torch.Generator, batch: int, channels: int, opts: Augment3DOptions,
                             device=None) -> Augment3DParams:
    """Draw the parameters of ``batch`` volumes of ``channels`` channels from
    ``generator``, with the JAX package's ranges."""
    f, m = opts.scale_factor, opts.max_intensity_shift
    return Augment3DParams(
        angle=_uniform(generator, batch, -opts.rot_degrees, opts.rot_degrees, device),
        scale=_uniform(generator, batch, 1.0 / f, f, device),
        field=opts.elastic_sigma * torch.randn((batch, 2, 3, 3), generator=generator, device=device),
        shift=_uniform(generator, (batch, channels), -m, m, device),
        flip=torch.rand((batch, 3), generator=generator, device=device) < 0.5,
    )


@functools.lru_cache(maxsize=None)
def _keys_cubic_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) float32 weights of ``jax.image.resize(..., "cubic")``
    along one axis (``jax._src.image.scale.compute_weight_mat``): Keys'
    cubic with a = -0.5 at half-pixel centres, each output's weights
    renormalised over the taps inside the input, and zero where an output's
    sample lies outside [-0.5, in_len - 0.5]."""
    sample = (np.arange(out_len) + 0.5) * (in_len / out_len) - 0.5
    x = np.abs(sample[:, None] - np.arange(in_len)[None, :])
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _cubic_weights(in_len: int, out_len: int, device: torch.device) -> torch.Tensor:
    """``_keys_cubic_matrix`` on ``device``, copied there once."""
    return torch.from_numpy(_keys_cubic_matrix(in_len, out_len)).to(device)


def elastic_field(coarse: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """The displacement field (B, 2, H, W) of a coarse (B, 2, h, w) one:
    ``jax.image.resize(coarse, (2, H, W), "cubic")`` of each, as two
    contractions with the cubic weight matrices, in exact f32 elementwise
    products (no TF32 matmul)."""
    wh = _cubic_weights(coarse.shape[2], size[0], coarse.device)  # (H, h)
    ww = _cubic_weights(coarse.shape[3], size[1], coarse.device)  # (W, w)
    rows = (coarse.unsqueeze(2) * wh.view(1, 1, *wh.shape, 1)).sum(3)  # (B, 2, H, w)
    return (rows.unsqueeze(3) * ww.view(1, 1, 1, *ww.shape)).sum(-1)


def _base_grid(batch: int, size: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    nh, nw = size
    rows = torch.arange(nh, dtype=torch.float32, device=device).view(1, nh, 1).expand(batch, nh, nw)
    cols = torch.arange(nw, dtype=torch.float32, device=device).view(1, 1, nw).expand(batch, nh, nw)
    return rows, cols


def _rotate(rows: torch.Tensor, cols: torch.Tensor, angle: torch.Tensor, size: Tuple[int, int]):
    """Inverse-rotate dst coords about the image centre (``_apply_rotation``)."""
    nh, nw = size
    cy, cx = (nh - 1) / 2.0, (nw - 1) / 2.0
    t = torch.deg2rad(angle).view(-1, 1, 1)
    c, s = torch.cos(t), torch.sin(t)
    ry, rx = rows - cy, cols - cx
    return (s * rx + c * ry) + cy, (c * rx - s * ry) + cx


def _source_coords(params: AugmentParams, size: Tuple[int, int], opts: AugmentOptions):
    """dst->src (rows, cols), each (B, H, W) float32: the base grid, then the
    elastic displacement, the scale-crop and the rotation
    (``unet_zoo_tpu/data/augment.py`` ``_apply_elastic``,
    ``_apply_scale_crop``, ``_apply_rotation``), in the same f32 operations.
    Gate-off images are selected around the warp, so their parameters need
    no gating here."""
    nh, nw = size
    rows, cols = _base_grid(params.angle.shape[0], size, params.angle.device)
    if opts.do_elasticaug:
        d = elastic_field(params.field, size)
        rows, cols = rows + d[:, 0], cols + d[:, 1]
    if opts.do_scaleaug:
        scale = params.r.float().view(-1, 1, 1)
        rows = (rows + 0.5) * (scale / nh) - 0.5 + params.off_r.float().view(-1, 1, 1)
        cols = (cols + 0.5) * (scale / nw) - 0.5 + params.off_c.float().view(-1, 1, 1)
    if opts.do_rotations:
        rows, cols = _rotate(rows, cols, params.angle, size)
    return rows, cols


def _zoom(coord: torch.Tensor, n: int, scale: torch.Tensor) -> torch.Tensor:
    """dst->src along an axis of n pixels resized to m = round(n * scale) and
    centre-cropped or padded back to n (the JAX package's 3D scale)."""
    m = torch.round(n * scale)
    delta = torch.div(m - n, 2, rounding_mode="floor")
    return (coord + delta + 0.5) * (torch.full_like(m, n) / m) - 0.5  # n / m divided, not n * (1 / m)


def _source_coords_3d(params: Augment3DParams, size: Tuple[int, int], opts: Augment3DOptions):
    """The in-plane dst->src (rows, cols) of each volume, (B, H, W) float32:
    the base grid, the elastic displacement, the scale and the rotation, in
    the JAX package's f32 operations (``_augment_one_3d``)."""
    nh, nw = size
    rows, cols = _base_grid(params.angle.shape[0], size, params.angle.device)
    if opts.do_elastic:
        d = elastic_field(params.field, size)
        rows, cols = rows + d[:, 0], cols + d[:, 1]
    if opts.do_scale:
        scale = params.scale.view(-1, 1, 1)
        rows, cols = _zoom(rows, nh, scale), _zoom(cols, nw, scale)
    if opts.do_rotate:
        rows, cols = _rotate(rows, cols, params.angle, size)
    return rows, cols


def _taps(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``img`` (B, L, H, W, C) at integer (B, H', W') coords, shared by the L
    leading slices; 0 where a coord falls outside the image."""
    b, lead, h, w, ch = img.shape
    valid = ((r >= 0) & (r < h) & (c >= 0) & (c < w)).reshape(b, 1, -1, 1)
    idx = (r.clamp(0, h - 1) * w + c.clamp(0, w - 1)).reshape(b, 1, -1, 1).expand(-1, lead, -1, ch)
    v = torch.gather(img.reshape(b, lead, h * w, ch), 2, idx)
    return v.masked_fill(~valid, 0).reshape(b, lead, *r.shape[1:], ch)


def _gather_bilinear(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Sample (B, [D,] H, W, C) float32 at (B, H', W') coords, bilinear, the
    same in-plane coords for every D slice; a tap outside the image
    contributes 0 (``_tap_weights``'s zero border, ``map_coordinates``'
    mode="constant"). Rows are interpolated first, then columns, the order
    of the JAX package's two contractions."""
    lead = img.shape[1:-3]
    x = img.reshape(img.shape[0], -1, *img.shape[-3:])
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = (rows - r0).unsqueeze(-1).unsqueeze(1), (cols - c0).unsqueeze(-1).unsqueeze(1)
    r0, c0 = r0.long(), c0.long()
    left = (1 - fr) * _taps(x, r0, c0) + fr * _taps(x, r0 + 1, c0)
    right = (1 - fr) * _taps(x, r0, c0 + 1) + fr * _taps(x, r0 + 1, c0 + 1)
    out = (1 - fc) * left + fc * right
    return out.reshape(img.shape[0], *lead, *rows.shape[1:], img.shape[-1])


def _round_half_away(t: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, exactly (``lax.round``'s default)."""
    whole = torch.trunc(t)
    return whole + torch.where((t - whole).abs() >= 0.5, torch.sign(t), 0.0)


def _gather_nearest(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Sample (B, [D,] H, W, C) at the nearest source pixel of (B, H', W')
    coords, 0 outside: ``map_coordinates(order=0, mode="constant")``."""
    lead = img.shape[1:-3]
    x = img.reshape(img.shape[0], -1, *img.shape[-3:])
    out = _taps(x, _round_half_away(rows).long(), _round_half_away(cols).long())
    return out.reshape(img.shape[0], *lead, *rows.shape[1:], img.shape[-1])


def _flip(x: torch.Tensor, coin: torch.Tensor, dim: int) -> torch.Tensor:
    coin = coin.view(-1, *([1] * (x.ndim - 1)))
    return torch.where(coin, x.flip(dim), x)


def warp_batch_2d(images: torch.Tensor, labels: torch.Tensor, params: AugmentParams,
                  opts: AugmentOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``params`` to images (B, H, W, C) float and labels (B, H, W)
    int; returns tensors of the same shapes and dtypes, on the same device."""
    _check(opts)
    size = tuple(images.shape[1:3])
    if opts.do_rotations or opts.do_scaleaug or opts.do_elasticaug:
        rows, cols = _source_coords(params, size, opts)
        c = images.shape[-1]
        if opts.label_interp == "onehot_linear" and opts.nlabels <= 4:
            onehot = F.one_hot(labels.long(), opts.nlabels).float()
            warped = _gather_bilinear(torch.cat([images.float(), onehot], -1), rows, cols)
            w_img = warped[..., :c].to(images.dtype)
            w_lbl = warped[..., c:].argmax(-1).to(labels.dtype)
        else:
            w_img = _gather_bilinear(images.float(), rows, cols).to(images.dtype)
            w_lbl = _gather_nearest(labels.unsqueeze(-1), rows, cols)[..., 0]
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


def warp_batch_3d(images: torch.Tensor, labels: torch.Tensor, params: Augment3DParams,
                  opts: Augment3DOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``params`` to images (B, D, H, W, C) float and labels (B, D, H,
    W, C') one-hot float or (B, D, H, W) int; returns tensors of the same
    shapes and dtypes, on the same device."""
    size = tuple(images.shape[2:4])
    c = images.shape[-1]
    lbl = labels if labels.ndim == images.ndim else labels.unsqueeze(-1)
    if opts.do_rotate or opts.do_scale or opts.do_elastic:
        rows, cols = _source_coords_3d(params, size, opts)
        if opts.onehot_labels:
            warped = _gather_bilinear(torch.cat([images.float(), lbl.float()], -1), rows, cols)
            images, lbl = warped[..., :c].to(images.dtype), warped[..., c:].to(lbl.dtype)
        else:
            images = _gather_bilinear(images.float(), rows, cols).to(images.dtype)
            lbl = _gather_nearest(lbl, rows, cols)
    if opts.do_intensity_shift:
        images = images + params.shift.view(-1, 1, 1, 1, c).to(images.dtype)
    if opts.do_flip:
        for k in range(3):
            images, lbl = _flip(images, params.flip[:, k], k + 1), _flip(lbl, params.flip[:, k], k + 1)
    return images, (lbl if labels.ndim == images.ndim else lbl[..., 0])


def augment_batch_3d(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                     opts: Augment3DOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw a batch's 3D parameters from ``generator`` and warp: images
    (B, D, H, W, C) float, labels one-hot (B, D, H, W, C') or (B, D, H, W) int."""
    params = sample_augment_3d_params(generator, images.shape[0], images.shape[-1], opts, images.device)
    return warp_batch_3d(images, labels, params, opts)
