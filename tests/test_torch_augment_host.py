"""The port's host (cv2) augmentation (``unet_zoo_tpu_torch.data.augment_host``)
against the JAX package's: both are numpy and cv2, so equal seeds must give
equal arrays, bit for bit.

* ``_augment_one`` and ``_augment_one_3d_host`` for several option sets
  and seeds, ``augment_batch_host``/``augment_batch_host_3d`` with a seeded
  generator;
* ``PrefetchingLoader``: its batches in order, a producer's error raised in
  the consumer, ``close``;
* ``Trainer.train`` with ``augment_on="host"`` on the CPU: 2 steps fed the
  host chain's batches (and no device warp); a missing cv2 raises an
  ``ImportError`` at construction, never the device path.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from unet_zoo_tpu.data import augment as jax_augment
from unet_zoo_tpu.data import augment_host as jax_host
from unet_zoo_tpu_torch.data import LIDCData, synthetic
from unet_zoo_tpu_torch.data import augment_host as host
from unet_zoo_tpu_torch.data.augment import Augment3DOptions, AugmentOptions
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.training import Trainer

SIZE = 24
OPTIONS_2D = {
    "lidc": dict(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=2, offset=6),
    "elastic": dict(do_rotations=True, do_elasticaug=True, elastic_sigma=2.0, do_fliplr=True, nlabels=3,
                    augment_every_nth=1),
    "nearest": dict(do_rotations=True, do_scaleaug=True, do_elasticaug=True, nlabels=3, offset=4,
                    label_interp="nearest", augment_every_nth=1),
    "five_labels": dict(do_rotations=True, do_scaleaug=True, nlabels=5, offset=4, augment_every_nth=1),
}
OPTIONS_3D = {
    "all": {},
    "shrink": dict(do_elastic=False, scale_factor=1.3, max_intensity_shift=0.5),
    "rotate_only": dict(do_scale=False, do_elastic=False, do_flip=False, do_intensity_shift=False, rot_degrees=45.0),
}


def _images_2d(n, nlabels, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, SIZE, SIZE, 1)).astype(np.float32)
    y = rng.integers(0, nlabels, (n, SIZE, SIZE)).astype(np.int32)
    return x, y


def _volumes(n, onehot, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, 6, 12, 10, 4)).astype(np.float32)
    lbl = rng.integers(0, 3, (n, 6, 12, 10))
    if onehot:
        y = np.stack([lbl > 0, lbl > 1, lbl == 2], axis=-1).astype(np.float32)
    else:
        y = lbl.astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", sorted(OPTIONS_2D))
def test_augment_one_matches_jax(name):
    kw = OPTIONS_2D[name]
    x, y = _images_2d(6, kw["nlabels"], seed=len(name))
    for seed in range(6):
        got = host._augment_one(x[seed, ..., 0], y[seed], AugmentOptions(**kw), seed)
        want = jax_host._augment_one(x[seed, ..., 0], y[seed], jax_augment.AugmentOptions(**kw), seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, seed)


@pytest.mark.parametrize("name", sorted(OPTIONS_2D))
def test_augment_batch_host_matches_jax(name):
    kw = OPTIONS_2D[name]
    x, y = _images_2d(5, kw["nlabels"], seed=3)
    got = host.augment_batch_host(x, y, AugmentOptions(**kw), np.random.default_rng(11))
    want = jax_host.augment_batch_host(x, y, jax_augment.AugmentOptions(**kw), np.random.default_rng(11))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
    got = host.augment_batch_host(x[..., 0], y, AugmentOptions(**kw))  # (B, H, W) images, seed root 0
    want = jax_host.augment_batch_host(x[..., 0], y, jax_augment.AugmentOptions(**kw))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("onehot", [True, False], ids=["onehot", "int"])
@pytest.mark.parametrize("name", sorted(OPTIONS_3D))
def test_augment_3d_matches_jax(name, onehot):
    kw = OPTIONS_3D[name]
    x, y = _volumes(3, onehot, seed=5)
    got = host.augment_batch_host_3d(x, y, Augment3DOptions(**kw), np.random.default_rng(2))
    want = jax_host.augment_batch_host_3d(x, y, jax_augment.Augment3DOptions(**kw), np.random.default_rng(2))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
    g1 = host._augment_one_3d_host(x[0], y[0], Augment3DOptions(**kw), 7)
    w1 = jax_host._augment_one_3d_host(x[0], y[0], jax_augment.Augment3DOptions(**kw), 7)
    assert all(np.array_equal(g, w) for g, w in zip(g1, w1))


class _Provider:
    def __init__(self, fail_at=None):
        self.calls, self.fail_at = 0, fail_at

    def next_batch(self, batch_size):
        self.calls += 1
        if self.calls == self.fail_at:
            raise OSError("read failed")
        x, y = _images_2d(batch_size, 2, seed=self.calls)
        return x, y


def test_prefetching_loader_order_errors_and_close():
    opts = AugmentOptions(**OPTIONS_2D["lidc"])
    loader = host.PrefetchingLoader(_Provider(), 3, opts=opts, rng=np.random.default_rng(4))
    rng = np.random.default_rng(4)
    for i in range(1, 4):  # the provider's batches in order, each through the chain with the loader's generator
        want = host.augment_batch_host(*_images_2d(3, 2, seed=i), opts, rng)
        got = loader.next_batch(3)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="batches of 3"):
        loader.next_batch(4)
    loader.close()
    assert not loader._thread.is_alive()

    loader = host.PrefetchingLoader(_Provider(fail_at=2), 2, opts=None)
    loader.next_batch(2)
    with pytest.raises(OSError, match="read failed"):
        loader.next_batch(2)
    loader._thread.join(timeout=5.0)
    assert not loader._thread.is_alive()
    loader.close()
    assert loader._thread not in threading.enumerate()


TOY = dict(experiment_name="toy_host", model="unet", filter_channels=(4, 8), image_size=(SIZE, SIZE), batch_size=2,
           augmentation_options=AugmentOptions(**OPTIONS_2D["lidc"]), augment_on="host", logging_frequency=1)


def test_trainer_trains_on_host_augmented_batches(tmp_path, monkeypatch):
    """Two steps of ``Trainer.train`` with ``augment_on="host"``: each step
    gets the provider's batch through the cv2 chain with a generator seeded
    from the seed (``host_rng``), which the device does not warp again;
    the loader is closed after the loop."""
    cfg = ExperimentConfig(**TOY)
    tr = Trainer(cfg, device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    seen, closed = [], []
    step = tr.train_step
    monkeypatch.setattr(tr, "train_step", lambda x, y: seen.append((x.clone(), y.clone())) or step(x, y))
    close = host.PrefetchingLoader.close
    monkeypatch.setattr(host.PrefetchingLoader, "close", lambda self: closed.append(1) or close(self))
    warps = []
    monkeypatch.setattr("unet_zoo_tpu_torch.training.trainer.warp_batch_2d", lambda *a: warps.append(1))
    aux = tr.train(LIDCData(synthetic.lidc_splits((6, 2, 2), SIZE, seed=1), seed=3), iterations=2, validate=False)
    assert tr.state.step == 2 and np.isfinite(float(aux["loss"])) and closed == [1] and not warps
    provider = LIDCData(synthetic.lidc_splits((6, 2, 2), SIZE, seed=1), seed=3).train
    rng = np.random.default_rng(cfg.seed)
    for x, y in seen:
        want = host.augment_batch_host(*provider.next_batch(2), cfg.augmentation_options, rng)
        assert np.array_equal(x.numpy(), want[0]) and np.array_equal(y.numpy(), want[1])
    tr.close()


def test_missing_cv2_raises_at_construction(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not host.host_augmentation_available()
    with pytest.raises(ImportError, match="cv2"):
        Trainer(ExperimentConfig(**TOY), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    with pytest.raises(ImportError, match="cv2"):
        host.augment_batch_host(*_images_2d(2, 2), AugmentOptions())
    # device augmentation needs no cv2
    cfg = dataclasses.replace(ExperimentConfig(**TOY), augment_on="device")
    tr = Trainer(cfg, device="cpu", log_dir=str(tmp_path / "dev"), tensorboard=False)
    tr.train_step(*(torch.from_numpy(a) for a in _images_2d(2, 2)))
    tr.close()
