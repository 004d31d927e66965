"""Host-side minibatch sampling over HDF5 datasets or arrays, a jax-free
copy of ``unet_zoo_tpu.data.batch_provider``.

The host samples indices, reads the records, picks an annotator and lays
the batch out; augmentation runs on the device inside the train step
(``data/augment.py``). Semantics and the numpy RNG stream are the JAX
package's, so that equal seeds give equal batches:

* sampling without replacement across batches: every example is seen
  before any repeats;
* batch indices sorted ascending (h5py fancy indexing needs it);
* one annotator drawn per example among ``annotator_range``;
* ``iterate_batches``, an epoch iterator with a ragged last batch;
* an optional nearest-neighbour ``resize_to`` zoom (scipy, order 0);
* a channel axis appended last (NHWC) for single-channel images.

The reference computes ``normalise_images`` and discards the result, so
images pass through unnormalised; ``normalise=False`` is the default for
that reason. The JAX package's ``rescale_range`` and ``rescale_rgb`` have
no caller among the ported loaders and are left out.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import zoom

from unet_zoo_tpu_torch.utils.profiling import span


def resize_batch(imgs: np.ndarray, target_size: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour resize of a batch's spatial axes to ``target_size``."""
    factors = (1.0,) + tuple(float(t) / s for t, s in zip(target_size, imgs.shape[1:1 + len(target_size)]))
    factors = factors + (1.0,) * (imgs.ndim - len(factors))
    return zoom(imgs, factors, order=0)


def normalise_images(imgs: np.ndarray) -> np.ndarray:
    """Per-image zero mean and unit standard deviation."""
    out = np.empty_like(imgs, dtype=np.float32)
    for i in range(imgs.shape[0]):
        img = imgs[i].astype(np.float32)
        out[i] = (img - img.mean()) / max(img.std(), 1e-8)
    return out


class BatchProvider:
    """Random minibatches without replacement over (X, y) arrays or h5py
    datasets. ``rng`` makes the sampling reproducible."""

    def __init__(
        self,
        X,
        y,
        indices: np.ndarray,
        add_dummy_dimension: bool = False,
        num_labels_per_subject: int = 1,
        annotator_range: Optional[Sequence[int]] = None,
        resize_to: Optional[Sequence[int]] = None,
        normalise: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        self.X = X
        self.y = y
        self.indices = np.asarray(indices)
        self.unused_indices = self.indices.copy()
        self.add_dummy_dimension = add_dummy_dimension
        self.num_labels_per_subject = num_labels_per_subject
        self.annotator_range = (list(annotator_range) if annotator_range is not None
                                else list(range(num_labels_per_subject)))
        self.resize_to = resize_to
        self.normalise = normalise
        self.rng = rng if rng is not None else np.random.default_rng()

    def next_batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """One random batch, sampled without replacement across calls; the
        span ``uz.data.next_batch`` in a profile."""
        with span("data.next_batch"):
            if len(self.unused_indices) < batch_size:
                self.unused_indices = self.indices
            batch_indices = self.rng.choice(self.unused_indices, batch_size, replace=False)
            self.unused_indices = np.setdiff1d(self.unused_indices, batch_indices)
            return self._load(np.sort(batch_indices))

    def iterate_batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch in batches of ``batch_size``, the last one ragged."""
        idx = self.indices.copy()
        if shuffle:
            self.rng.shuffle(idx)
        for b in range(0, len(idx), batch_size):
            yield self._load(np.sort(idx[b:b + batch_size]))

    def _load(self, batch_indices: np.ndarray):
        X_batch = self.X[batch_indices, ...]
        y_batch = self.y[batch_indices, ...]
        if self.num_labels_per_subject > 1:
            y_batch = self._select_random_label(y_batch)
        return self._post_process(np.asarray(X_batch, dtype=np.float32), np.asarray(y_batch))

    def _select_random_label(self, labels: np.ndarray) -> np.ndarray:
        """One annotator an example; the annotator axis is last (H, W, graders)."""
        picks = self.rng.choice(self.annotator_range, size=labels.shape[0])
        return np.stack([labels[i, ..., a] for i, a in enumerate(picks)], axis=0)

    def _post_process(self, X_batch, y_batch):
        if self.resize_to:
            X_batch = resize_batch(X_batch, self.resize_to)
            if y_batch.ndim > 1:
                y_batch = resize_batch(y_batch, self.resize_to)
        if self.normalise:
            X_batch = normalise_images(X_batch)
        if self.add_dummy_dimension:
            X_batch = np.expand_dims(X_batch, axis=-1)  # NHWC
        return X_batch, y_batch.astype(np.int32)
