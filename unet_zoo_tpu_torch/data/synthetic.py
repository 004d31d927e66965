"""Synthetic LIDC-, UZH- and BraTS-schema data, a jax-free copy of
``unet_zoo_tpu.data.synthetic`` (the same RNG streams, so the same arrays
at the same seed).

LIDC: images are smooth random blobs; graders are correlated noisy
dilations of a ground-truth mask, some of them empty, like LIDC's
4-annotator disagreement. UZH: the same blobs with 6 graders, each case's
masks carrying one label in [1, num_classes). BraTS: 4-channel noise
volumes with a nested spherical tumour (labels 1, 2, 4 from the outside
in) a case. The ``make_*_cache`` functions write through ``data.cache``
(HDF5 where ``h5py`` imports, else the npy directory beside the HDF5 path);
``lidc_splits``, ``uzh_arrays`` and ``brats_arrays`` build the caches'
arrays in memory, which ``LIDCData``, ``UZHProstateData`` and ``BratsData``
read as they read an open cache.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from unet_zoo_tpu_torch.data.cache import find_cache, open_cache, write_cache

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
    """Write ``lidc_splits`` as a cache with the LIDC schema at ``path``
    (``data.cache.write_cache``); returns the path written."""
    return write_cache(path, lidc_splits(num_per_split, size, seed))


def synthetic_lidc(tmpdir: str, annotator_range=None, num_per_split=(24, 8, 8), size: int = 128, seed: int = 0):
    """``LIDCData`` over a synthetic cache in ``tmpdir``, written once."""
    from unet_zoo_tpu_torch.data.lidc import LIDCData

    path = os.path.join(tmpdir, f"synthetic_lidc_{size}.hdf5")
    if find_cache(path) is None:
        make_lidc_cache(path, num_per_split=num_per_split, size=size, seed=seed)
    return LIDCData(open_cache(path), annotator_range=annotator_range, seed=seed)


def uzh_arrays(num_per_split: Tuple[int, int, int] = (24, 8, 8), size: int = 128, num_classes: int = 3,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """The UZH cache's schema in memory: ``images_<split>`` (n, size, size)
    float32, ``masks_<split>`` (n, size, size, 6) uint8 and
    ``patient_id_<split>`` uint8, for train, validation and test."""
    rng = np.random.default_rng(seed)
    out = {}
    for tt, n in zip(("train", "validation", "test"), num_per_split):
        imgs, msks = [], []
        for _ in range(n):
            image, masks = _blob_case(rng, size, 6)
            lbl = masks * rng.integers(1, num_classes, size=1).astype(np.uint8)
            imgs.append(image)
            msks.append(lbl.transpose(1, 2, 0))
        out[f"images_{tt}"] = np.asarray(imgs, dtype=np.float32)
        out[f"masks_{tt}"] = np.asarray(msks, dtype=np.uint8)
        out[f"patient_id_{tt}"] = np.arange(n, dtype=np.uint8)
    return out


def make_uzh_cache(path: str, num_per_split: Tuple[int, int, int] = (24, 8, 8), size: int = 128,
                   num_classes: int = 3, seed: int = 0) -> str:
    """Write ``uzh_arrays`` as a cache with the UZH schema at ``path``
    (``data.cache.write_cache``); returns the path written."""
    return write_cache(path, uzh_arrays(num_per_split, size, num_classes, seed))


def brats_arrays(num_per_split: Tuple[int, int] = (4, 2), size: Tuple[int, int, int] = (32, 32, 32), seed: int = 0,
                 keep_offsets: bool = False) -> Dict[str, np.ndarray]:
    """The BraTS cache's schema in memory: ``images_<split>`` (n, D, H, W, 4)
    float32, ``masks_<split>`` (n, D, H, W) uint8 in {0, 1, 2, 4} and
    ``pids_<split>`` int64 for train and validation, an empty test split,
    and with ``keep_offsets`` the crop offsets ``prepare_data(keep_offsets=True)``
    records (a crop box of the grid's size, an original volume a few voxels larger)."""
    rng = np.random.default_rng(seed)
    d, h, w = size
    out = {}
    for tt, n in zip(("train", "validation"), num_per_split):
        out[f"images_{tt}"] = rng.standard_normal((n, d, h, w, 4)).astype(np.float32)
        masks = np.zeros((n, d, h, w), dtype=np.uint8)
        zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
        for i in range(n):
            cz, cy, cx = (rng.uniform(0.3, 0.7, 3) * np.array(size)).astype(int)
            r = int(0.2 * min(size))
            dist = np.sqrt((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2)
            masks[i][dist < r] = 1
            masks[i][dist < 0.6 * r] = 2
            masks[i][dist < 0.3 * r] = 4
        out[f"masks_{tt}"] = masks
        out[f"pids_{tt}"] = np.arange(n, dtype=np.int64)
        if keep_offsets:
            lo = rng.integers(0, 5, (n, 3)).astype(np.int64)
            hi = lo + np.asarray(size)
            for j, name in enumerate(("xOffsets", "yOffsets", "zOffsets")):
                out[f"{name}_{tt}"] = lo[:, j]
            out[f"cropHi_{tt}"] = hi
            out[f"origShape_{tt}"] = hi + rng.integers(0, 4, (n, 3)).astype(np.int64)
    out["images_test"] = np.zeros((0, d, h, w, 4), np.float32)
    out["masks_test"] = np.zeros((0, d, h, w), np.uint8)
    out["pids_test"] = np.zeros((0,), np.int64)
    return out


def make_brats_cache(path: str, num_per_split: Tuple[int, int] = (4, 2), size: Tuple[int, int, int] = (32, 32, 32),
                     seed: int = 0, keep_offsets: bool = False) -> str:
    """Write ``brats_arrays`` as a cache with the BraTS schema at ``path``
    (``data.cache.write_cache``); returns the path written."""
    return write_cache(path, brats_arrays(num_per_split, size, seed, keep_offsets))
