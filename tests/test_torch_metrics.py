"""The port's GED, variance-NCC and Dice against the JAX package's, on the
same numpy inputs: N = 7 samples and M = 4 annotators of 16x16 label maps
with 2 and 3 classes, empty masks among them, and identical sets.

Intersections are exact integers in float32 on both sides, so the
distances differ only in the order of their sums: GED within 1e-6
absolute. NCC's means and standard deviations differ by rounding: within
1e-5, and NaN where JAX gives NaN (a constant error map). Dice is a ratio
of exact counts: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.metrics import dice as jax_dice
from unet_zoo_tpu.metrics import ged as jax_ged
from unet_zoo_tpu.metrics.ncc import ncc as jax_ncc_fn
from unet_zoo_tpu.metrics.ncc import variance_ncc_dist as jax_variance_ncc_dist
from unet_zoo_tpu.metrics.ncc import variance_ncc_dist_class_first as jax_variance_ncc_dist_class_first
from unet_zoo_tpu_torch import metrics

N, M, SIZE = 7, 4, 16
GED_ATOL = 1e-6
NCC_ATOL = 1e-5


def _labels(rng, k, n_classes, empty=()):
    """k label maps of blobs of each class; the maps in ``empty`` are all background."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    out = np.zeros((k, SIZE, SIZE), np.int32)
    for i in range(k):
        if i in empty:
            continue
        for c in range(1, n_classes):
            cy, cx = rng.uniform(3, SIZE - 3, 2)
            out[i][(yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(4, 20)] = c
    return out


def _cases(n_classes):
    rng = np.random.default_rng(n_classes)
    samples = _labels(rng, N, n_classes, empty=(2,))
    gts = _labels(rng, M, n_classes, empty=(0, 3))
    return {
        "random": (samples, gts),
        "all_empty": (np.zeros_like(samples), np.zeros_like(gts)),
        "samples_empty": (np.zeros_like(samples), gts),
        "identical": (np.repeat(gts[1:2], N, 0), np.repeat(gts[1:2], M, 0)),
    }


CASES = [(c, name) for c in (2, 3) for name in ("random", "all_empty", "samples_empty", "identical")]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n_classes,case", CASES)
def test_ged_matches_jax(n_classes, case):
    samples, gts = _cases(n_classes)[case]
    label_range = list(range(1, n_classes))
    for nlabels in (n_classes - 1, n_classes):  # the reference's divisor quirk: nlabels > len(label_range)
        want = float(jax_ged.generalised_energy_distance(jnp.asarray(samples), jnp.asarray(gts), nlabels, label_range))
        got = metrics.generalised_energy_distance(_t(samples), _t(gts), nlabels, label_range)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), want, rtol=0, atol=GED_ATOL)
        stacked = np.concatenate([samples, gts])
        want_d = np.asarray(jax_ged.pairwise_iou_distance(jnp.asarray(stacked), nlabels, label_range))
        got_d = metrics.pairwise_iou_distance(_t(stacked), nlabels, label_range).numpy()
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=GED_ATOL)
    # the default label range covers every label from 0
    want = float(jax_ged.generalised_energy_distance(jnp.asarray(samples), jnp.asarray(gts), n_classes))
    np.testing.assert_allclose(metrics.generalised_energy_distance(_t(samples), _t(gts), n_classes).item(), want,
                               rtol=0, atol=GED_ATOL)


def test_intersections_are_exact_counts():
    samples, gts = _cases(3)["random"]
    stacked = np.concatenate([samples, gts])
    for lbl in (0, 1, 2):
        inter, sizes = metrics.pairwise_intersections(_t(stacked), lbl)
        binm = (stacked.reshape(len(stacked), -1) == lbl).astype(np.int64)
        assert np.array_equal(inter.numpy(), binm @ binm.T) and np.array_equal(sizes.numpy(), binm.sum(1))
        with torch.autocast("cpu", dtype=torch.bfloat16):  # stays float32 under autocast
            assert metrics.pairwise_intersections(_t(stacked), lbl)[0].dtype == torch.float32


def _probs(rng, k, n_classes, sharp=3.0):
    logits = sharp * rng.standard_normal((k, SIZE, SIZE, n_classes)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n_classes,case", CASES)
def test_variance_ncc_matches_jax_in_both_layouts(n_classes, case):
    samples, gts = _cases(n_classes)[case]
    rng = np.random.default_rng(10 + n_classes)
    # softmax samples around the sampled labels; "identical" gives one-hot
    # samples that all agree, a constant E_ss, and so NaN on both sides
    probs = (np.eye(n_classes, dtype=np.float32)[samples] if case == "identical"
             else 0.5 * np.eye(n_classes, dtype=np.float32)[samples] + 0.5 * _probs(rng, N, n_classes))
    onehot = np.eye(n_classes, dtype=np.float32)[gts]
    want = float(jax_variance_ncc_dist(jnp.asarray(probs), jnp.asarray(onehot)))
    got = metrics.variance_ncc_dist(_t(probs), _t(onehot)).item()
    probs_cf, onehot_cf = np.moveaxis(probs, -1, 0), np.moveaxis(onehot, -1, 0)
    want_cf = float(jax_variance_ncc_dist_class_first(jnp.asarray(probs_cf), jnp.asarray(onehot_cf)))
    got_cf = metrics.variance_ncc_dist_class_first(_t(probs_cf), _t(onehot_cf)).item()
    assert np.isnan(want) == (case == "identical") and np.isnan(want_cf) == np.isnan(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=NCC_ATOL, equal_nan=True)
    np.testing.assert_allclose(got_cf, want_cf, rtol=0, atol=NCC_ATOL, equal_nan=True)
    assert np.isnan(got) == np.isnan(want) and np.isnan(got_cf) == np.isnan(want_cf)


@pytest.mark.parametrize("zero_norm", [True, False])
def test_ncc_matches_jax(zero_norm):
    rng = np.random.default_rng(3)
    a, v = rng.standard_normal((2, SIZE, SIZE)).astype(np.float32) + 2.0
    want = float(jax_ncc_fn(jnp.asarray(a), jnp.asarray(v), zero_norm=zero_norm))
    np.testing.assert_allclose(metrics.ncc(_t(a), _t(v), zero_norm=zero_norm).item(), want, rtol=0, atol=NCC_ATOL)
    # a map with itself gives 1 with the population standard deviation
    # (jnp.std); torch's unbiased default would give (n - 1) / n
    np.testing.assert_allclose(metrics.ncc(_t(a), _t(a)).item(), 1.0, rtol=1e-5)
    assert np.isnan(metrics.ncc(torch.ones(5), torch.arange(5.0)).item())  # eps 0: a constant map gives NaN
    assert np.isclose(metrics.ncc(torch.ones(5), torch.arange(5.0), eps=1.0).item(), 0.0)


@pytest.mark.parametrize("n_classes,case", CASES)
def test_dice_matches_jax(n_classes, case):
    samples, gts = _cases(n_classes)[case]
    for pred, gt in zip(samples[:M], gts):
        want = np.asarray(jax_dice.dice_per_label(jnp.asarray(pred), jnp.asarray(gt), n_classes))
        got = metrics.dice_per_label(_t(pred), _t(gt), n_classes)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
        for c in range(n_classes):
            want_c = float(jax_dice.dice_binary(jnp.asarray(pred == c), jnp.asarray(gt == c)))
            assert metrics.dice_binary(_t(pred == c), _t(gt == c)).item() == want_c


def test_dice_empty_conventions():
    empty, full = torch.zeros(4, 4), torch.ones(4, 4)
    assert metrics.dice_binary(empty, empty).item() == 1.0
    assert metrics.dice_binary(empty, full).item() == 0.0 == metrics.dice_binary(full, empty).item()
    assert metrics.dice_binary(full, full).item() == 1.0
