"""The port's 2D and 3D device augmentation against the JAX package's.

``jax_draws`` reproduces the draws of the JAX ``augment_batch_2d`` for a key
(``split(key, B)``, then ``split(k, 8)`` per image, ``data/augment.py``),
the coarse elastic field included, and hands them to the port's
``warp_batch_2d``; the JAX side warps at ``warp_precision="highest"``, exact
f32, as the port's gather is. ``jax_draws_3d`` does the same for the JAX
``augment_batch_3d`` (``split(k, 7)`` a volume). The elastic field is held
against ``jax.image.resize(..., "cubic")`` directly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.data.augment import Augment3DOptions as JaxAugment3DOptions
from unet_zoo_tpu.data.augment import AugmentOptions as JaxAugmentOptions
from unet_zoo_tpu.data.augment import augment_batch_2d as jax_augment_batch_2d
from unet_zoo_tpu.data.augment import augment_batch_3d as jax_augment_batch_3d
from unet_zoo_tpu_torch.data import augment
from unet_zoo_tpu_torch.data.augment import (
    Augment3DOptions,
    Augment3DParams,
    AugmentOptions,
    AugmentParams,
    augment_batch_2d,
    augment_batch_3d,
    elastic_field,
    sample_augment_3d_params,
    sample_augment_params,
    warp_batch_2d,
    warp_batch_3d,
)

# the image: both sides compute the same f32 coordinates, up to the last bit
# of sin/cos, and interpolate in the same order
IMAGE_ATOL = 1e-5
# labels: exact wherever the two largest warped one-hot channels differ by
# more than LABEL_TIE; near a tie the argmax may go either way
LABEL_TIE = 1e-5
LABEL_AGREEMENT = 0.999
# the elastic field: the same Keys weights (the port's built in float64 and
# rounded once, JAX's in f32) contracted in f32
FIELD_OF_MAX = 1e-6


def jax_draws(key, batch, size, opts) -> AugmentParams:
    """The draws the JAX ``augment_batch_2d(key, ...)`` makes, as the port's
    ``AugmentParams`` (raw, before the JAX package gates them: the gate-off
    images do not use them)."""
    nh, nw = size
    p_flip = max(2, opts.augment_every_nth)

    def one(k):
        k_gate, k_rot, k_r, k_py, k_px, k_el, k_lr, k_ud = jax.random.split(k, 8)
        r = jax.random.randint(k_r, (), nh - opts.offset, nh + 1)
        return (jax.random.randint(k_gate, (), 0, opts.augment_every_nth) == 0,
                jax.random.uniform(k_rot, (), minval=-opts.rot_degrees, maxval=opts.rot_degrees),
                r,
                jax.random.randint(k_py, (), 0, nh - r + 1),
                jax.random.randint(k_px, (), 0, nw - r + 1),
                jax.random.randint(k_lr, (), 0, p_flip) == 0,
                jax.random.randint(k_ud, (), 0, p_flip) == 0,
                opts.elastic_sigma * jax.random.normal(k_el, (2, 3, 3)))

    gate, angle, r, off_r, off_c, flip_lr, flip_ud, field = (
        torch.from_numpy(np.array(d)) for d in jax.vmap(one)(jax.random.split(key, batch)))
    return AugmentParams(gate, angle, r.long(), off_r.long(), off_c.long(), flip_lr, flip_ud, field)


def jax_draws_3d(key, batch, channels, opts: Augment3DOptions) -> Augment3DParams:
    """The draws the JAX ``augment_batch_3d(key, ...)`` makes, as the port's
    ``Augment3DParams``."""

    def one(k):
        k_rot, k_sc, k_el, k_int, *k_flip = jax.random.split(k, 7)
        m = opts.max_intensity_shift
        return (jax.random.uniform(k_rot, (), minval=-opts.rot_degrees, maxval=opts.rot_degrees),
                jax.random.uniform(k_sc, (), minval=1.0 / opts.scale_factor, maxval=opts.scale_factor),
                opts.elastic_sigma * jax.random.normal(k_el, (2, 3, 3)),
                jax.random.uniform(k_int, (channels,), minval=-m, maxval=m),
                jnp.stack([jax.random.bernoulli(kf) for kf in k_flip]))

    return Augment3DParams(*(torch.from_numpy(np.array(d)) for d in jax.vmap(one)(jax.random.split(key, batch))))


def jax_options(opts: AugmentOptions) -> JaxAugmentOptions:
    return JaxAugmentOptions(**dataclasses.asdict(opts), warp_precision="highest")


def _batch(batch, size, channels, nlabels, seed):
    """Smooth images and blob labels, so that the warp moves real edges."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((batch, size + 4, size + 4, channels)).astype(np.float32)
    x = sum(noise[:, i:i + size, j:j + size] for i in range(5) for j in range(5)) / 5
    y = np.digitize(x[..., 0], np.quantile(x[..., 0], np.linspace(0, 1, nlabels + 1)[1:-1]))
    return x.astype(np.float32), y.astype(np.int32)


def _port(x, y, params, opts):
    out = warp_batch_2d(torch.from_numpy(x), torch.from_numpy(y), params, opts)
    return out[0].numpy(), out[1].numpy()


LIDC = AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=2)


@pytest.mark.parametrize("channels,nlabels", [(1, 2), (3, 4)])
def test_warp_matches_jax_with_injected_draws(channels, nlabels):
    opts = dataclasses.replace(LIDC, nlabels=nlabels)
    x, y = _batch(16, 32, channels, nlabels, seed=nlabels)
    key = jax.random.PRNGKey(nlabels)
    params = jax_draws(key, 16, (32, 32), opts)
    want_x, want_y = (np.asarray(a) for a in jax_augment_batch_2d(key, jnp.asarray(x), jnp.asarray(y),
                                                                 jax_options(opts)))
    got_x, got_y = _port(x, y, params, opts)
    assert got_x.dtype == x.dtype and got_y.dtype == y.dtype
    assert got_x.shape == x.shape and got_y.shape == y.shape
    assert params.gate.any() and not params.gate.all()  # both kinds of image are exercised
    np.testing.assert_allclose(got_x, want_x, atol=IMAGE_ATOL)

    # the label margin of the port's warp, before the flips
    rows, cols = augment._source_coords(params, (32, 32), opts)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(y).long(), nlabels).float()
    top2 = augment._gather_bilinear(onehot, rows, cols).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    for b in range(16):  # flip the margin as the labels were flipped
        if params.flip_lr[b]:
            margin[b] = margin[b, :, ::-1]
        if params.flip_ud[b]:
            margin[b] = margin[b, ::-1]
    gate = params.gate.numpy()
    clear = (margin > LABEL_TIE) | ~gate[:, None, None]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_y[clear], want_y[clear])
    assert (got_y == want_y).mean() >= LABEL_AGREEMENT

    # gate-off images: the input, bit-exact on both sides, flipped exactly
    for b in np.flatnonzero(~gate):
        img, lbl = x[b], y[b]
        if params.flip_lr[b]:
            img, lbl = img[:, ::-1], lbl[:, ::-1]
        if params.flip_ud[b]:
            img, lbl = img[::-1], lbl[::-1]
        for out_x, out_y in ((got_x, got_y), (want_x, want_y)):
            np.testing.assert_array_equal(out_x[b], img)
            np.testing.assert_array_equal(out_y[b], lbl)


def test_flips_alone_are_bit_exact():
    opts = AugmentOptions(do_fliplr=True, do_flipud=True, nlabels=2)
    x, y = _batch(16, 24, 2, 2, seed=7)
    key = jax.random.PRNGKey(7)
    params = jax_draws(key, 16, (24, 24), opts)
    want = jax_augment_batch_2d(key, jnp.asarray(x), jnp.asarray(y), jax_options(opts))
    got = _port(x, y, params, opts)
    assert params.flip_lr.any() and params.flip_ud.any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_no_options_pass_through():
    x, y = _batch(4, 16, 1, 2, seed=8)
    params = sample_augment_params(torch.Generator().manual_seed(0), 4, (16, 16), AugmentOptions())
    got = _port(x, y, params, AugmentOptions())
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], y)


def test_sampled_params_follow_the_jax_ranges():
    opts = dataclasses.replace(LIDC, augment_every_nth=3, rot_degrees=15.0, offset=20)
    p = sample_augment_params(torch.Generator().manual_seed(0), 20000, (48, 64), opts)
    assert all(t.shape == (20000,) for t in p[:-1]) and p.field.shape == (20000, 2, 3, 3)
    assert abs(p.field.std().item() - opts.elastic_sigma) < 0.1 and abs(p.field.mean().item()) < 0.05
    assert p.gate.dtype == p.flip_lr.dtype == p.flip_ud.dtype == torch.bool
    assert abs(p.gate.float().mean().item() - 1 / 3) < 0.02
    assert abs(p.flip_lr.float().mean().item() - 1 / 3) < 0.02  # 1/max(2, every_nth)
    assert abs(p.flip_ud.float().mean().item() - 1 / 3) < 0.02
    assert p.angle.abs().max().item() <= 15.0 and abs(p.angle.mean().item()) < 0.5
    assert p.r.min().item() == 28 and p.r.max().item() == 48  # U{n - offset .. n}, n = H
    for off, n in ((p.off_r, 48), (p.off_c, 64)):  # U{0 .. n - r}, each with its own r
        assert (off >= 0).all() and (off <= n - p.r).all()
        assert (off == 0).any() and (off == n - p.r).any()
    again = sample_augment_params(torch.Generator().manual_seed(0), 20000, (48, 64), opts)
    assert all(torch.equal(a, b) for a, b in zip(p, again))


def test_augment_batch_is_sample_then_warp():
    x, y = (torch.from_numpy(a) for a in _batch(4, 32, 1, 2, seed=9))
    got = augment_batch_2d(torch.Generator().manual_seed(3), x, y, LIDC)
    params = sample_augment_params(torch.Generator().manual_seed(3), 4, (32, 32), LIDC)
    want = warp_batch_2d(x, y, params, LIDC)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_options_from_dict_match_jax():
    d = {"do_rotations": True, "do_scaleaug": True, "do_flip_lr": True, "do_flipud": True,
         "rot_degrees": 12.0, "offset": 10, "augment_every_nth": 3, "sigma": 5.0}
    got = dataclasses.asdict(AugmentOptions.from_dict(d, nlabels=3))
    want = dataclasses.asdict(JaxAugmentOptions.from_dict(d, nlabels=3))
    assert want.pop("warp_precision") == "high"
    assert got == want
    assert AugmentOptions.from_dict(None, 4) == AugmentOptions(nlabels=4)


@pytest.mark.parametrize("change", [{"do_elasticaug": True}, {"label_interp": "nearest"}, {"nlabels": 5}])
def test_unported_options_raise(change):
    """The options that raised before the elastic warp and the nearest label
    warp were ported now run (``test_elastic_and_nearest_match_jax`` holds
    them against the JAX package); an unknown label interpolation raises."""
    opts = dataclasses.replace(LIDC, **change)
    x, y = torch.zeros(1, 8, 8, 1), torch.zeros(1, 8, 8, dtype=torch.int64)
    got = augment_batch_2d(torch.Generator(), x, y, opts)
    assert got[0].shape == x.shape and got[1].shape == y.shape and got[1].dtype == y.dtype
    with pytest.raises(ValueError, match="label_interp"):
        augment_batch_2d(torch.Generator(), x, y, dataclasses.replace(opts, label_interp="cubic"))


@pytest.mark.parametrize("size", [(32, 32), (7, 9), (128, 128), (16, 24)])
def test_elastic_field_matches_jax_image_resize(size):
    """Keys' cubic with a = -0.5 at half-pixel centres, the taps outside the
    3x3 grid dropped and the rest renormalised: ``jax.image.resize``'s, not
    torch's bicubic (a = -0.75, clamped)."""
    coarse = np.array(10.0 * jax.random.normal(jax.random.PRNGKey(3), (4, 2, 3, 3)))
    want = np.asarray(jax.vmap(lambda c: jax.image.resize(c, (2, *size), method="cubic"))(coarse))
    got = elastic_field(torch.from_numpy(coarse), size).numpy()
    assert got.shape == want.shape == (4, 2, *size)
    assert np.abs(got - want).max() <= FIELD_OF_MAX * np.abs(want).max()
    bicubic = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=size, mode="bicubic",
                                              align_corners=False).numpy()
    assert np.abs(bicubic - want).max() > 100 * FIELD_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("change", [{"do_elasticaug": True}, {"do_elasticaug": True, "label_interp": "nearest"},
                                    {"nlabels": 5}])
def test_elastic_and_nearest_match_jax(change):
    """The 2D elastic warp composed with the scale-crop and the rotation
    (JAX's ``"highest"`` warp, IMAGE_ATOL), and the nearest label warp
    (``label_interp="nearest"`` or more than 4 labels), exact."""
    opts = dataclasses.replace(LIDC, **change)
    x, y = _batch(16, 32, 2, opts.nlabels, seed=11)
    key = jax.random.PRNGKey(11)
    params = jax_draws(key, 16, (32, 32), opts)
    want_x, want_y = (np.asarray(a) for a in jax_augment_batch_2d(key, jnp.asarray(x), jnp.asarray(y),
                                                                 jax_options(opts)))
    got_x, got_y = _port(x, y, params, opts)
    assert params.gate.any() and not params.gate.all()
    np.testing.assert_allclose(got_x, want_x, atol=IMAGE_ATOL)
    if opts.label_interp == "nearest" or opts.nlabels > 4:
        np.testing.assert_array_equal(got_y, want_y)
    else:
        assert (got_y == want_y).mean() >= LABEL_AGREEMENT


def test_nearest_rounds_half_away_from_zero():
    """``map_coordinates(order=0)`` rounds x.5 away from zero, where
    ``torch.round`` rounds to even."""
    img = torch.arange(6, dtype=torch.int32).view(1, 1, 6, 1)
    cols = torch.tensor([[[0.5, 1.5, 2.5, -0.5, 4.49999, 5.5]]])
    got = augment._gather_nearest(img, torch.zeros_like(cols), cols)[0, 0, :, 0]
    assert got.tolist() == [1, 2, 3, 0, 4, 0]  # -0.5 -> -1 and 5.5 -> 6 fall outside: 0


def _volumes(batch, size, channels, seed):
    """Smooth noise volumes and their BraTS-style nested labels, one-hot WT/TC/ET."""
    rng = np.random.default_rng(seed)
    d, h, w = size
    noise = rng.standard_normal((batch, d + 2, h + 2, w + 2, channels)).astype(np.float32)
    x = sum(noise[:, i:i + d, j:j + h, k:k + w] for i in range(3) for j in range(3) for k in range(3)) / 5
    lbl = np.digitize(x[..., 0], [0.0, 0.4, 0.8])
    lbl = np.array([0, 1, 2, 4])[lbl]
    y = np.stack([lbl != 0, (lbl != 0) & (lbl != 2), lbl == 4], -1).astype(np.float32)
    return x.astype(np.float32), y, lbl.astype(np.int32)


def jax_3d_options(opts: Augment3DOptions) -> JaxAugment3DOptions:
    return JaxAugment3DOptions(**dataclasses.asdict(opts))


@pytest.mark.parametrize("change", [{}, {"onehot_labels": False}, {"do_elastic": False, "do_rotate": False},
                                    {"do_scale": False, "do_flip": False, "do_intensity_shift": False}])
def test_warp_3d_matches_jax_with_injected_draws(change):
    """The shared in-plane grid (elastic, scale, rotation) warps every D
    slice: the image within IMAGE_ATOL, one-hot labels into soft labels
    within IMAGE_ATOL, integer labels by their nearest voxel exactly; then
    the shift and the three flips."""
    opts = dataclasses.replace(Augment3DOptions(), **change)
    x, y, lbl = _volumes(3, (6, 16, 12), 4, seed=12)
    labels = y if opts.onehot_labels else lbl
    key = jax.random.PRNGKey(12)
    params = jax_draws_3d(key, 3, 4, opts)
    want_x, want_y = (np.asarray(a) for a in jax_augment_batch_3d(key, jnp.asarray(x), jnp.asarray(labels),
                                                                 jax_3d_options(opts)))
    got_x, got_y = (t.numpy() for t in warp_batch_3d(torch.from_numpy(x), torch.from_numpy(labels), params, opts))
    assert got_x.dtype == x.dtype and got_y.dtype == labels.dtype and got_y.shape == labels.shape
    np.testing.assert_allclose(got_x, want_x, atol=IMAGE_ATOL)
    if opts.onehot_labels:
        np.testing.assert_allclose(got_y, want_y, atol=IMAGE_ATOL)
    else:
        np.testing.assert_array_equal(got_y, want_y)
    if opts.do_flip:
        assert params.flip.any() and not params.flip.all()


def test_flips_and_shift_3d_are_exact():
    opts = Augment3DOptions(do_rotate=False, do_scale=False, do_elastic=False)
    x, y, _ = _volumes(4, (5, 6, 7), 2, seed=13)
    params = sample_augment_3d_params(torch.Generator().manual_seed(1), 4, 2, opts)
    got_x, got_y = warp_batch_3d(torch.from_numpy(x), torch.from_numpy(y), params, opts)
    for b in range(4):
        want_x, want_y = x[b] + params.shift[b].numpy(), y[b]
        for k in range(3):
            if params.flip[b, k]:
                want_x, want_y = np.flip(want_x, k), np.flip(want_y, k)
        np.testing.assert_array_equal(got_x[b].numpy(), want_x)
        np.testing.assert_array_equal(got_y[b].numpy(), want_y)


def test_sampled_3d_params_follow_the_jax_ranges():
    opts = Augment3DOptions(rot_degrees=15.0, scale_factor=1.2, elastic_sigma=5.0, max_intensity_shift=0.2)
    p = sample_augment_3d_params(torch.Generator().manual_seed(0), 20000, 4, opts)
    assert p.angle.shape == p.scale.shape == (20000,) and p.field.shape == (20000, 2, 3, 3)
    assert p.shift.shape == (20000, 4) and p.flip.shape == (20000, 3) and p.flip.dtype == torch.bool
    assert p.angle.abs().max().item() <= 15.0 and abs(p.angle.mean().item()) < 0.5
    assert 1 / 1.2 <= p.scale.min().item() and p.scale.max().item() <= 1.2
    assert p.shift.abs().max().item() <= 0.2 and abs(p.field.std().item() - 5.0) < 0.05
    assert abs(p.flip.float().mean().item() - 0.5) < 0.02
    x, y, _ = (torch.from_numpy(a) for a in _volumes(2, (4, 8, 8), 4, seed=14))
    got = augment_batch_3d(torch.Generator().manual_seed(3), x, y, opts)
    want = warp_batch_3d(x, y, sample_augment_3d_params(torch.Generator().manual_seed(3), 2, 4, opts), opts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_3d_options_match_jax():
    assert dataclasses.asdict(Augment3DOptions()) == dataclasses.asdict(JaxAugment3DOptions())
