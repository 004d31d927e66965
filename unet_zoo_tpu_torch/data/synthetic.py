"""Synthetic LIDC-schema data, a jax-free copy of the LIDC part of
``unet_zoo_tpu.data.synthetic`` (the same RNG stream, so the same arrays
at the same seed).

Images are smooth random blobs; graders are correlated noisy dilations of
a ground-truth mask, some of them empty, like LIDC's 4-annotator
disagreement. ``h5py`` is imported only by the functions that write or
open HDF5; ``lidc_splits`` builds the cache's arrays in memory, which
``LIDCData`` reads as it reads an open HDF5 file.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

SPLITS = ("train", "val", "test")


def _blob_case(rng, size: int, num_graders: int):
    """One case: image (size, size) float32 around [0, 1], masks (graders, size, size) uint8."""
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    r = rng.uniform(0.08, 0.2) * size
    dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    image = np.exp(-((dist / (1.5 * r)) ** 2)) + 0.05 * rng.standard_normal((size, size))
    masks = []
    for _ in range(num_graders):
        jitter = rng.uniform(0.85, 1.15)
        empty = rng.random() < 0.15  # some graders see no lesion
        m = (dist < r * jitter) & (not empty)
        masks.append(m.astype(np.uint8))
    return image.astype(np.float32), np.asarray(masks)


def make_lidc_pickle(path: str, num_cases: int = 40, num_subjects: int = 10, size: int = 128,
                     seed: int = 0) -> str:
    """The raw input's twin, a LIDC crops pickle for ``data.lidc.prepare_data``."""
    rng = np.random.default_rng(seed)
    data = {}
    for i in range(num_cases):
        image, masks = _blob_case(rng, size, 4)
        data[i] = {"image": image, "masks": masks, "series_uid": f"subject_{i % num_subjects:03d}"}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def lidc_splits(num_per_split: Tuple[int, int, int] = (24, 8, 8), size: int = 128,
                seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """The LIDC cache's schema in memory: {train, val, test} x {images
    (n, size, size) float64 with the -0.5 offset, labels (n, size, size, 4)
    uint8, uids (n,) int64}."""
    rng = np.random.default_rng(seed)
    out = {}
    for tt, n in zip(SPLITS, num_per_split):
        imgs, lbls = [], []
        for _ in range(n):
            image, masks = _blob_case(rng, size, 4)
            imgs.append(image.astype(np.float64) - 0.5)
            lbls.append(masks.transpose(1, 2, 0))
        out[tt] = {"images": np.asarray(imgs), "labels": np.asarray(lbls, dtype=np.uint8),
                   "uids": np.arange(n, dtype=np.int64)}
    return out


def make_lidc_cache(path: str, num_per_split: Tuple[int, int, int] = (24, 8, 8), size: int = 128,
                    seed: int = 0) -> str:
    """Write ``lidc_splits`` as an HDF5 cache with the LIDC schema."""
    import h5py

    with h5py.File(path, "w") as f:
        for tt, arrays in lidc_splits(num_per_split, size, seed).items():
            g = f.create_group(tt)
            for name in ("images", "labels", "uids"):
                g.create_dataset(name, data=arrays[name])
    return path


def synthetic_lidc(tmpdir: str, annotator_range=None, num_per_split=(24, 8, 8), size: int = 128, seed: int = 0):
    """``LIDCData`` over a synthetic HDF5 cache in ``tmpdir``, written once."""
    import h5py

    from unet_zoo_tpu_torch.data.lidc import LIDCData

    path = os.path.join(tmpdir, f"synthetic_lidc_{size}.hdf5")
    if not os.path.exists(path):
        make_lidc_cache(path, num_per_split=num_per_split, size=size, seed=seed)
    return LIDCData(h5py.File(path, "r"), annotator_range=annotator_range, seed=seed)
