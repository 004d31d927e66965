"""LIDC-IDRI lung nodules: pickle -> HDF5 cache -> batch providers, a
jax-free copy of ``unet_zoo_tpu.data.lidc``.

The raw input is the public LIDC crops pickle (key -> {'image': 128x128
float, 'masks': 4x128x128, 'series_uid'}). Preprocessing as in the JAX
package: a subject-level split by series uid, 80/20 test then 80/20 of the
rest for validation (64/16/20); images stored as float64 with a -0.5
offset; labels as (H, W, 4 graders) uint8; HDF5 groups train/val/test,
each with images, labels and uids.

The cache is written and read through ``data.cache``: HDF5 where ``h5py``
imports, else a directory of ``.npy`` files with the same groups and
datasets; the subject split is ``data.cache.train_test_split``,
scikit-learn's split without scikit-learn. ``LIDCData`` reads its splits as
``data[split]["images"]``, so an open HDF5 file, an ``NpyCache`` and a dict
of arrays with the same schema serve alike. ``loader="native"`` serves the
train split through the C++ batch store (``native.store``).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from unet_zoo_tpu_torch.data.batch_provider import BatchProvider
from unet_zoo_tpu_torch.data.cache import load_or_build, train_test_split, write_cache

log = logging.getLogger(__name__)


def prepare_data(input_file: str, output_file: str, seed: Optional[int] = None) -> str:
    """Build the cache ``output_file`` from the raw LIDC pickle (HDF5, or
    its npy directory where ``h5py`` does not import); returns the path
    written."""
    with open(input_file, "rb") as f:
        data = pickle.load(f)

    unique_subjects = np.unique([v["series_uid"] for v in data.values()])
    split_ids = {}
    train_and_val, split_ids["test"] = train_test_split(unique_subjects, test_size=0.2, random_state=seed)
    split_ids["train"], split_ids["val"] = train_test_split(train_and_val, test_size=0.2, random_state=seed)
    subset_of = {sid: tt for tt, ids in split_ids.items() for sid in ids}

    images = {tt: [] for tt in split_ids}
    labels = {tt: [] for tt in split_ids}
    uids = {tt: [] for tt in split_ids}
    for value in data.values():
        tt = subset_of[value["series_uid"]]
        images[tt].append(value["image"].astype(np.float64) - 0.5)
        labels[tt].append(np.asarray(value["masks"]).transpose((1, 2, 0)))  # (H, W, graders)
        uids[tt].append(hash(value["series_uid"]))

    return write_cache(output_file, {tt: {"uids": np.asarray(uids[tt], dtype=np.int64),
                                          "labels": np.asarray(labels[tt], dtype=np.uint8),
                                          "images": np.asarray(images[tt], dtype=np.float64)} for tt in split_ids})


def load_and_maybe_process_data(input_file: str, preprocessing_folder: str, force_overwrite: bool = False):
    """The cache ``data_lidc.hdf5`` (or its npy directory) in
    ``preprocessing_folder``, built from ``input_file`` first if there is
    no readable one; an open ``h5py.File`` or ``NpyCache``."""
    return load_or_build(os.path.join(preprocessing_folder, "data_lidc.hdf5"),
                         lambda path: prepare_data(input_file, path), force_overwrite)


class LIDCData:
    """Train, validation and test ``BatchProvider``s over the LIDC cache,
    sharing one numpy generator seeded with ``seed``. ``annotator_range``
    defaults to all 4 graders. ``loader="native"`` serves the train split
    through the C++ batch store (``native.store.train_provider_from_h5``:
    the same sampling and RNG stream, so the same batches at the same seed,
    gathered on C++ threads a batch ahead); it needs ``batch_size`` and a
    cache on disk, and takes no ``resize_to``. Validation and test read
    the cache."""

    NUM_LABELS_PER_SUBJECT = 4

    def __init__(self, data_file, annotator_range: Optional[Sequence[int]] = None, resize_to=None,
                 seed: Optional[int] = None, loader: str = "h5py", batch_size: Optional[int] = None):
        if loader not in ("h5py", "native"):
            raise ValueError(f"unknown loader '{loader}'")
        self.data = data_file
        ar = list(annotator_range) if annotator_range is not None else list(range(self.NUM_LABELS_PER_SUBJECT))
        rng = np.random.default_rng(seed)

        def provider(tt):
            d = self.data[tt]
            return BatchProvider(d["images"], d["labels"], np.arange(d["images"].shape[0]), add_dummy_dimension=True,
                                 num_labels_per_subject=self.NUM_LABELS_PER_SUBJECT, annotator_range=ar,
                                 resize_to=resize_to, rng=rng)

        if loader == "native":
            from unet_zoo_tpu_torch.native.store import native_train_provider

            self.train = native_train_provider(self.data, batch_size, resize_to, images="train/images", labels="train/labels",
                                               num_labels_per_subject=self.NUM_LABELS_PER_SUBJECT,
                                               annotator_range=ar, rng=rng)
        else:
            self.train = provider("train")
        self.validation = provider("val")
        self.test = provider("test")
        # the raw arrays, for evaluation against every grader
        for split, tt in ((self.validation, "val"), (self.test, "test")):
            split.images = self.data[tt]["images"]
            split.labels = self.data[tt]["labels"]

    @classmethod
    def from_config(cls, sys_config, exp_config) -> "LIDCData":
        f = load_and_maybe_process_data(input_file=sys_config.data_root,
                                         preprocessing_folder=sys_config.preproc_folder)
        return cls(f, annotator_range=exp_config.annotator_range, resize_to=exp_config.resize_to,
                   seed=exp_config.data_seed, loader=exp_config.loader, batch_size=exp_config.batch_size)
