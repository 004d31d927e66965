"""LIDC-IDRI lung nodules: pickle -> HDF5 cache -> batch providers, a
jax-free copy of ``unet_zoo_tpu.data.lidc``.

The raw input is the public LIDC crops pickle (key -> {'image': 128x128
float, 'masks': 4x128x128, 'series_uid'}). Preprocessing as in the JAX
package: a subject-level split by series uid, 80/20 test then 80/20 of the
rest for validation (64/16/20); images stored as float64 with a -0.5
offset; labels as (H, W, 4 graders) uint8; HDF5 groups train/val/test,
each with images, labels and uids.

``h5py`` and ``sklearn`` are imported by the functions that use them.
``LIDCData`` reads its splits as ``data[split]["images"]``, so an open HDF5
file and a dict of arrays with the same schema serve alike.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from unet_zoo_tpu_torch.data.batch_provider import BatchProvider

log = logging.getLogger(__name__)


def prepare_data(input_file: str, output_file: str, seed: Optional[int] = None) -> None:
    """Build the HDF5 cache from the raw LIDC pickle."""
    import h5py
    from sklearn.model_selection import train_test_split

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

    with h5py.File(output_file, "w") as f:
        for tt in split_ids:
            g = f.create_group(tt)
            g.create_dataset("uids", data=np.asarray(uids[tt], dtype=np.int64))
            g.create_dataset("labels", data=np.asarray(labels[tt], dtype=np.uint8))
            g.create_dataset("images", data=np.asarray(images[tt], dtype=np.float64))
    log.info("wrote LIDC cache to %s", output_file)


def load_and_maybe_process_data(input_file: str, preprocessing_folder: str, force_overwrite: bool = False):
    """The cache ``data_lidc.hdf5`` in ``preprocessing_folder``, built from
    ``input_file`` first if it is missing; an open ``h5py.File``."""
    import h5py

    os.makedirs(preprocessing_folder, exist_ok=True)
    path = os.path.join(preprocessing_folder, "data_lidc.hdf5")
    if not os.path.exists(path) or force_overwrite:
        prepare_data(input_file, path)
    return h5py.File(path, "r")


class LIDCData:
    """Train, validation and test ``BatchProvider``s over the LIDC cache,
    sharing one numpy generator seeded with ``seed``. ``annotator_range``
    defaults to all 4 graders. ``loader="native"`` (the JAX package's C++
    store) is not ported and raises."""

    NUM_LABELS_PER_SUBJECT = 4

    def __init__(self, data_file, annotator_range: Optional[Sequence[int]] = None, resize_to=None,
                 seed: Optional[int] = None, loader: str = "h5py"):
        if loader == "native":
            raise NotImplementedError("loader='native' (the JAX package's C++ store) is not ported to PyTorch yet; "
                                      "use loader='h5py'")
        if loader != "h5py":
            raise ValueError(f"unknown loader '{loader}'")
        self.data = data_file
        ar = list(annotator_range) if annotator_range is not None else list(range(self.NUM_LABELS_PER_SUBJECT))
        rng = np.random.default_rng(seed)

        def provider(tt):
            d = self.data[tt]
            return BatchProvider(d["images"], d["labels"], np.arange(d["images"].shape[0]), add_dummy_dimension=True,
                                 num_labels_per_subject=self.NUM_LABELS_PER_SUBJECT, annotator_range=ar,
                                 resize_to=resize_to, rng=rng)

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
                   seed=exp_config.data_seed, loader=exp_config.loader)
