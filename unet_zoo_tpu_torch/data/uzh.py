"""UZH prostate MR slices: NIfTI -> HDF5 cache -> batch providers, a
jax-free copy of ``unet_zoo_tpu.data.uzh`` (and its ``.mat`` variant).

Preprocessing as in the JAX package (the reference's
``uzh_prostate_data_loader.py``): 6 expert annotations a case; the split by
patient id (id % 5 == 0 test, else id % 4 == 0 validation, else train);
case 9 skipped; each volume normalised to zero mean and unit std before it
is sliced; each slice rescaled from its pixel size to ``target_resolution``
(linear for the image, nearest for the masks), then centre cropped or
zero-padded to ``size``; label 3 (the seminal vesicles) set to 0. The cache
holds ``images_<split>`` (N, H, W) float32, ``masks_<split>`` (N, H, W, 6)
uint8 with the annotator axis last, and ``patient_id_<split>`` uint8.

``UZHProstateData`` reads its splits as ``data["images_train"]`` and so
on, so an open HDF5 file, an ``NpyCache`` and a dict of arrays with the
same keys serve alike. The cache is written and read through
``data.cache`` (HDF5 where ``h5py`` imports, else a directory of ``.npy``
files); ``scipy.io`` is imported only by ``UZHMatData``.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import zoom

from unet_zoo_tpu_torch.data.batch_provider import BatchProvider
from unet_zoo_tpu_torch.data.cache import load_or_build, write_cache
from unet_zoo_tpu_torch.utils.nii import load_nii

log = logging.getLogger(__name__)

EXPERT_LIST = (
    "Readings_AH",
    "Readings_EK",
    "Readings_KC",
    "Readings_KS",
    "Readings_OD",
    "Readings_UM",
)
SPLITS = ("train", "validation", "test")


def crop_or_pad_slice_to_size(sl: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Centre crop or zero-pad the leading two axes to (nx, ny)."""
    x, y = sl.shape[:2]
    x_s, y_s = (x - nx) // 2, (y - ny) // 2
    x_c, y_c = (nx - x) // 2, (ny - y) // 2
    if x >= nx and y >= ny:
        return sl[x_s:x_s + nx, y_s:y_s + ny, ...]
    out = np.zeros((nx, ny) + sl.shape[2:], dtype=sl.dtype)
    if x < nx and y >= ny:
        out[x_c:x_c + x, :, ...] = sl[:, y_s:y_s + ny, ...]
    elif x >= nx and y < ny:
        out[:, y_c:y_c + y, ...] = sl[x_s:x_s + nx, :, ...]
    else:
        out[x_c:x_c + x, y_c:y_c + y, ...] = sl
    return out


def normalise_image(image: np.ndarray) -> np.ndarray:
    """Zero mean and unit standard deviation, in float32."""
    img = image.astype(np.float32)
    return (img - img.mean()) / max(float(img.std()), 1e-8)


def _rescale_slice(sl: np.ndarray, scale_vector, order: int) -> np.ndarray:
    """Rescale the leading axes by ``scale_vector`` (scipy's ``zoom``, order
    1 for an image, 0 for masks); trailing axes keep their size."""
    factors = tuple(scale_vector) + (1.0,) * (sl.ndim - len(scale_vector))
    return zoom(sl, factors, order=order)


def split_for_patient(patient_id: int) -> str:
    if patient_id % 5 == 0:
        return "test"
    if patient_id % 4 == 0:
        return "validation"
    return "train"


def prepare_data(input_image_folder: str, input_mask_folder: str, output_file: str, size: Tuple[int, int],
                 target_resolution: Tuple[float, float]) -> str:
    """Build the cache ``output_file`` (HDF5, or its npy directory where
    ``h5py`` does not import) from case folders ``888<id>/t2_tse_tra.nii.gz``
    in ``input_image_folder`` and one folder an expert (``EXPERT_LIST``) of
    ``*<id:04d>_*.nii.gz`` masks in ``input_mask_folder``; returns the path
    written. As in the JAX package, an empty split is written as
    ``np.asarray([])`` and the patient ids as uint8 (ids above 255 wrap)."""
    nx, ny = size
    slices = {tt: ([], []) for tt in SPLITS}
    pids = {tt: [] for tt in SPLITS}
    for folder in sorted(os.listdir(input_image_folder)):
        folder_path = os.path.join(input_image_folder, folder)
        if not (os.path.isdir(folder_path) and folder.startswith("888")):
            continue
        patient_id = int(folder[3:])
        if patient_id == 9:  # its annotations have the wrong dimensions
            log.warning("skipping case 9 (bad annotation dims)")
            continue
        tt = split_for_patient(patient_id)

        img, _, header = load_nii(os.path.join(folder_path, "t2_tse_tra.nii.gz"))
        masks = []
        for exp in EXPERT_LIST:
            pat = os.path.join(input_mask_folder, exp, f"*{str(patient_id).zfill(4)}_*.nii.gz")
            files = glob.glob(pat)
            assert len(files) == 1, f"glob {pat} matched {len(files)} files"
            masks.append(load_nii(files[0])[0])
        masks_arr = np.asarray(masks).transpose((1, 2, 3, 0))  # (X, Y, Z, expert)

        img = normalise_image(img)
        pixdim = header.structarr["pixdim"]
        scale_vector = [pixdim[1] / target_resolution[0], pixdim[2] / target_resolution[1]]
        for zz in range(img.shape[2]):
            sl = _rescale_slice(np.squeeze(img[:, :, zz]), scale_vector, order=1)
            ms = _rescale_slice(np.squeeze(masks_arr[:, :, zz, :]), scale_vector, order=0)
            sl = crop_or_pad_slice_to_size(sl, nx, ny)
            ms = crop_or_pad_slice_to_size(ms, nx, ny)
            ms[ms == 3] = 0  # remove the seminal vesicles
            slices[tt][0].append(sl.astype(np.float32))
            slices[tt][1].append(ms.astype(np.uint8))
            pids[tt].append(patient_id)

    arrays = {}
    for tt in SPLITS:
        arrays[f"images_{tt}"] = np.asarray(slices[tt][0])
        arrays[f"masks_{tt}"] = np.asarray(slices[tt][1])
        arrays[f"patient_id_{tt}"] = np.asarray(pids[tt], dtype=np.uint8)
    return write_cache(output_file, arrays)


def load_and_maybe_process_data(input_image_folder: str, input_mask_folder: str, preprocessing_folder: str,
                                size: Tuple[int, int], target_resolution: Tuple[float, float],
                                force_overwrite: bool = False):
    """The cache ``data_uzh_prostate_<size>_<resolution>.hdf5`` (or its npy
    directory) in ``preprocessing_folder``, built first if there is no
    readable one; an open ``h5py.File`` or ``NpyCache``."""
    return load_or_build(os.path.join(preprocessing_folder, cache_name(size, target_resolution)),
                         lambda path: prepare_data(input_image_folder, input_mask_folder, path, size,
                                                   target_resolution), force_overwrite)


def cache_name(size: Tuple[int, int], target_resolution: Tuple[float, float]) -> str:
    """The HDF5 cache's file name at ``size`` and ``target_resolution``."""
    return "data_uzh_prostate_%s_%s.hdf5" % ("x".join(str(i) for i in size),
                                             "x".join(str(i) for i in target_resolution))


class UZHProstateData:
    """Train, validation and test ``BatchProvider``s over the UZH cache (an
    open HDF5 file or a dict of arrays with its keys), sharing one numpy
    generator seeded with ``seed``. ``annotator_range`` defaults to all 6
    experts. ``loader="native"`` serves the train split through the C++
    batch store, as ``LIDCData`` does (needs ``batch_size`` and a cache on
    disk; no ``resize_to``)."""

    NUM_LABELS_PER_SUBJECT = len(EXPERT_LIST)

    def __init__(self, data_file, annotator_range: Optional[Sequence[int]] = None, resize_to=None,
                 seed: Optional[int] = None, loader: str = "h5py", batch_size: Optional[int] = None):
        if loader not in ("h5py", "native"):
            raise ValueError(f"unknown loader '{loader}'")
        self.data = data_file
        ar = list(annotator_range) if annotator_range is not None else list(range(self.NUM_LABELS_PER_SUBJECT))
        rng = np.random.default_rng(seed)

        def provider(tt):
            imgs = self.data[f"images_{tt}"]
            return BatchProvider(imgs, self.data[f"masks_{tt}"], np.arange(imgs.shape[0]), add_dummy_dimension=True,
                                 num_labels_per_subject=self.NUM_LABELS_PER_SUBJECT, annotator_range=ar,
                                 resize_to=resize_to, rng=rng)

        if loader == "native":
            from unet_zoo_tpu_torch.native.store import native_train_provider

            self.train = native_train_provider(self.data, batch_size, resize_to, images="images_train", labels="masks_train",
                                               num_labels_per_subject=self.NUM_LABELS_PER_SUBJECT,
                                               annotator_range=ar, rng=rng)
        else:
            self.train = provider("train")
        self.validation = provider("validation")
        self.test = provider("test")
        # the raw arrays, for evaluation against every expert
        for split, tt in ((self.validation, "validation"), (self.test, "test")):
            split.images = self.data[f"images_{tt}"]
            split.labels = self.data[f"masks_{tt}"]

    @classmethod
    def from_config(cls, sys_config, exp_config) -> "UZHProstateData":
        """The cache at the experiment's ``image_size`` and
        ``target_resolution``. As in the JAX package, ``resize_to`` is not
        passed on: the cache is made at the image size."""
        f = load_and_maybe_process_data(input_image_folder=sys_config.uzh_input_image_folder,
                                        input_mask_folder=sys_config.uzh_input_mask_folder,
                                        preprocessing_folder=sys_config.uzh_preproc_folder,
                                        size=tuple(exp_config.image_size[:2]),
                                        target_resolution=tuple(exp_config.target_resolution))
        return cls(f, annotator_range=exp_config.annotator_range, seed=exp_config.data_seed,
                   loader=exp_config.loader, batch_size=exp_config.batch_size)


class UZHMatData:
    """The ``.mat`` variant: ``images`` (N, H, W) and ``labels`` (N, H, W,
    experts) read with ``scipy.io.loadmat``; the last 150 slices become
    validation (100) and test (50). As in the JAX package, the providers
    count their experts from ``labels.ndim`` (1 unless the labels are 4-D)."""

    NUM_LABELS_PER_SUBJECT = len(EXPERT_LIST)

    def __init__(self, mat_path: str, annotator_range: Optional[Sequence[int]] = None, seed: Optional[int] = None):
        from scipy.io import loadmat

        mat = loadmat(mat_path)
        images = np.asarray(mat["images"], dtype=np.float32)
        labels = np.asarray(mat["labels"], dtype=np.uint8)
        n = images.shape[0]
        idx_train = np.arange(0, n - 150)
        idx_val = np.arange(n - 150, n - 50)
        idx_test = np.arange(n - 50, n)
        ar = list(annotator_range) if annotator_range is not None else list(range(self.NUM_LABELS_PER_SUBJECT))
        rng = np.random.default_rng(seed)

        def provider(idx):
            return BatchProvider(images, labels, idx, add_dummy_dimension=True,
                                 num_labels_per_subject=labels.shape[-1] if labels.ndim == 4 else 1,
                                 annotator_range=ar, rng=rng)

        self.train = provider(idx_train)
        self.validation = provider(idx_val)
        self.test = provider(idx_test)
        for split, idx in ((self.validation, idx_val), (self.test, idx_test)):
            split.images = images[idx]
            split.labels = labels[idx]
