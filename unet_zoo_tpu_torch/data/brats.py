"""BraTS 2018 volumes: NIfTI -> HDF5 cache -> volume batches, a jax-free
copy of ``unet_zoo_tpu.data.brats``.

Preprocessing as in the JAX package (the reference's
``brats18_data_loader.py``): the 4 modalities stacked channel-last (t1,
t1ce, t2, flair); the nonzero bounding box cropped over all three spatial
axes; each channel standardised over its nonzero voxels, zeros kept; a
centre crop-or-pad to the target size (128^3); the patient-id split
(ids % 10 in {6, 7} validation, every other id train: the reference's
"test" branch is unreachable and so is kept unreachable); evaluation
labels one-hot WT/TC/ET = (l != 0, l != 0 and l != 2, l == 4); and the
crop offsets, for reassembling a prediction in the original geometry.

Volumes are (D, H, W, C), the model's NDHWC without the batch. ``BratsData``
reads its splits as ``data["images_train"]`` and so on, so an open HDF5
file, an ``NpyCache`` and a dict of arrays with the same schema serve
alike. The cache is written and read through ``data.cache`` (HDF5 where
``h5py`` imports, else a directory of ``.npy`` files); ``scipy`` is
imported only where a volume is resampled.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Optional, Tuple

import numpy as np

from unet_zoo_tpu_torch.data.cache import load_or_build, write_cache
from unet_zoo_tpu_torch.utils.nii import load_nii

log = logging.getLogger(__name__)

MODALITIES = ("t1", "t1ce", "t2", "flair")
SPLITS = ("train", "validation", "test")


def test_train_val_split(patient_id: int) -> str:
    """The reference's split by patient id (never 'test')."""
    if patient_id % 10 >= 8:
        return "train"
    if patient_id % 10 >= 6:
        return "validation"
    return "train"


def normalise_image(image: np.ndarray) -> np.ndarray:
    """Standardise each channel over its nonzero voxels; zeros stay zero."""
    img = image.astype(np.float32)
    nz = img != 0
    out = np.zeros_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        m = ch[nz[..., c]]
        if m.size == 0:
            continue
        out[..., c] = np.where(nz[..., c], (ch - m.mean()) / max(float(m.std()), 1e-8), 0.0)
    return out


def crop_volume_all_dim(image: np.ndarray, mask: Optional[np.ndarray] = None):
    """Strip the zero borders of all three spatial axes: (image, mask), or
    (image, (lo, hi)) without a mask."""
    coords = np.argwhere(image > 0)
    lo = coords.min(axis=0)[:3]
    hi = coords.max(axis=0)[:3] + 1
    image = image[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], :]
    if mask is not None:
        return image, mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    return image, (lo, hi)


def crop_or_pad_volume(vol: np.ndarray, target: Tuple[int, int, int], channels: Optional[int] = None) -> np.ndarray:
    """Centre crop or zero-pad the 3 spatial axes to ``target`` (float32)."""
    shape = tuple(target) + (channels,) if channels is not None else tuple(target)
    out = np.zeros(shape, dtype=np.float32)
    src_sl, dst_sl = [], []
    for t, s in zip(target, vol.shape[:3]):
        d = abs(t - s) // 2
        if s >= t:
            src_sl.append(slice(d, d + t))
            dst_sl.append(slice(0, t))
        else:
            src_sl.append(slice(0, s))
            dst_sl.append(slice(d, d + s))
    out[tuple(dst_sl)] = vol[tuple(src_sl)]
    return out


def to_evaluation_onehot(labels: np.ndarray) -> np.ndarray:
    """BraTS labels {0, 1, 2, 4} -> float32 WT/TC/ET channels."""
    out = np.zeros(labels.shape + (3,), dtype=np.float32)
    out[..., 0] = labels != 0
    out[..., 1] = (labels != 0) & (labels != 2)
    out[..., 2] = labels == 4
    return out


def reassemble_to_original(pred: np.ndarray, original_shape: Tuple[int, int, int], crop_lo: Tuple[int, int, int],
                           crop_hi: Tuple[int, int, int]) -> np.ndarray:
    """Place a prediction on the preprocessed grid (nonzero crop, then centre
    crop or pad) back into the original volume: the inverse of
    ``crop_volume_all_dim`` then ``crop_or_pad_volume``, from the offsets
    ``prepare_data(keep_offsets=True)`` records."""
    out = np.zeros(tuple(original_shape) + pred.shape[3:], dtype=pred.dtype)
    src_sl, dst_sl = [], []
    for t, lo, hi in zip(pred.shape[:3], crop_lo, crop_hi):
        s = hi - lo
        d = abs(t - s) // 2
        if s <= t:  # the grid was padded: take its centre
            src_sl.append(slice(d, d + s))
            dst_sl.append(slice(lo, lo + s))
        else:  # the crop box was larger: the prediction covers its centre
            src_sl.append(slice(0, t))
            dst_sl.append(slice(lo + d, lo + d + t))
    out[tuple(dst_sl)] = pred[tuple(src_sl)]
    return out


def prepare_data(input_folder: str, output_file: str, size: Tuple[int, int, int] = (128, 128, 128),
                 target_resolution: Tuple[float, float, float] = (1.0, 1.0, 1.0), keep_offsets: bool = False) -> str:
    """Build the cache ``output_file`` (HDF5, or its npy directory where
    ``h5py`` does not import) from raw BraTS folders, one a case holding
    ``<case>_<modality>.nii.gz`` and ``<case>_seg.nii.gz``; returns the
    path written."""
    vols = {tt: ([], [], []) for tt in SPLITS}
    offsets = {tt: [] for tt in SPLITS}  # (lo, hi, original shape) a case
    case_dirs = sorted(d for d in glob.glob(os.path.join(input_folder, "*")) if os.path.isdir(d))
    for pid, case_dir in enumerate(case_dirs):
        case = os.path.basename(case_dir)
        tt = test_train_val_split(pid)
        img = np.stack([load_nii(os.path.join(case_dir, f"{case}_{mod}.nii.gz"))[0] for mod in MODALITIES],
                       axis=-1).astype(np.float32)
        seg_path = os.path.join(case_dir, f"{case}_seg.nii.gz")
        mask = load_nii(seg_path)[0].astype(np.uint8) if os.path.exists(seg_path) else None

        # the nonzero box first, so that its offsets are kept with or without a mask
        orig_shape = np.asarray(img.shape[:3], dtype=np.int64)
        coords = np.argwhere(img > 0)
        lo = coords.min(axis=0)[:3]
        hi = coords.max(axis=0)[:3] + 1
        img = img[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], :]
        if mask is not None:
            mask = mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        offsets[tt].append((lo, hi, orig_shape))

        if tuple(target_resolution) != (1.0, 1.0, 1.0):
            from scipy.ndimage import zoom

            factors = tuple(1.0 / r for r in target_resolution)
            img = zoom(img, factors + (1.0,), order=1)
            if mask is not None:
                mask = zoom(mask, factors, order=0)

        img = crop_or_pad_volume(normalise_image(img), size, channels=len(MODALITIES))
        if mask is not None:
            mask = crop_or_pad_volume(mask, size).astype(np.uint8)
        vols[tt][0].append(img)
        vols[tt][1].append(mask if mask is not None else np.zeros(size, np.uint8))
        vols[tt][2].append(pid)

    arrays = {}
    for tt in SPLITS:
        arrays[f"images_{tt}"] = np.asarray(vols[tt][0], dtype=np.float32)
        arrays[f"masks_{tt}"] = np.asarray(vols[tt][1], dtype=np.uint8)
        arrays[f"pids_{tt}"] = np.asarray(vols[tt][2], dtype=np.int64)
        if keep_offsets:
            lo_a, hi_a, sh_a = (np.asarray([o[j] for o in offsets[tt]], np.int64).reshape(-1, 3) for j in range(3))
            for j, name in enumerate(("xOffsets", "yOffsets", "zOffsets")):
                arrays[f"{name}_{tt}"] = lo_a[:, j]
            arrays[f"cropHi_{tt}"] = hi_a
            arrays[f"origShape_{tt}"] = sh_a
    return write_cache(output_file, arrays)


def load_and_maybe_process_data(input_folder: str, preprocessing_folder: str,
                                size: Tuple[int, int, int] = (128, 128, 128), force_overwrite: bool = False):
    """The cache ``data_brats18_<size>.hdf5`` (or its npy directory) in
    ``preprocessing_folder``, built from ``input_folder`` first if there is
    no readable one; an open ``h5py.File`` or ``NpyCache``."""
    return load_or_build(os.path.join(preprocessing_folder, cache_name(size)),
                         lambda path: prepare_data(input_folder, path, size=size), force_overwrite)


def cache_name(size: Tuple[int, int, int]) -> str:
    """The HDF5 cache's file name at ``size``."""
    return "data_brats18_%s.hdf5" % "x".join(str(i) for i in size)


class _BratsSplit:
    """One split as a provider: ``next_batch`` without replacement until the
    split is used up, as ``BatchProvider``, and the raw ``images``/``labels``."""

    def __init__(self, parent: "BratsData", mode: str):
        self._parent = parent
        self._mode = mode
        self._indices = np.arange(parent.num_examples(mode))
        self._unused = self._indices.copy()

    @property
    def images(self):
        return self._parent.data[f"images_{self._mode}"]

    @property
    def labels(self):
        return self._parent.data[f"masks_{self._mode}"]

    def next_batch(self, batch_size: int):
        """(images (B, D, H, W, 4) float32, WT/TC/ET labels (B, D, H, W, 3) float32)."""
        rng = self._parent.rng
        if len(self._unused) < batch_size:
            self._unused = self._indices
        picks = rng.choice(self._unused, batch_size, replace=False)
        self._unused = np.setdiff1d(self._unused, picks)
        items = [self._parent.get(int(i), self._mode) for i in np.sort(picks)]
        return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


class BratsData:
    """The train, validation and test splits of a BraTS cache: an open HDF5
    file or a dict of arrays with its schema (``images_<split>`` (N, D, H,
    W, 4) float32, ``masks_<split>`` (N, D, H, W) labels in {0, 1, 2, 4},
    ``pids_<split>``, and with the offsets ``{x,y,z}Offsets_<split>``,
    ``cropHi_<split>``, ``origShape_<split>``), read a volume at a time.
    The augmentation runs on the device (``augment_batch_3d``). The JAX
    class's ``random_crop`` is not ported: no experiment sets it."""

    def __init__(self, data_file, seed: Optional[int] = None):
        self.data = data_file
        self.rng = np.random.default_rng(seed)
        self.train = _BratsSplit(self, "train")
        self.validation = _BratsSplit(self, "validation")
        self.test = _BratsSplit(self, "test")

    def num_examples(self, mode: str = "train") -> int:
        return self.data[f"images_{mode}"].shape[0]

    def get(self, index: int, mode: str = "train", onehot: bool = True):
        """(image (D, H, W, 4) float32, labels (D, H, W, 3) WT/TC/ET one-hot
        float32 or, without ``onehot``, the raw (D, H, W) labels, pid)."""
        # copies: a memory-mapped cache gives read-only views
        image = np.array(self.data[f"images_{mode}"][index], dtype=np.float32)
        labels = np.array(self.data[f"masks_{mode}"][index])
        pid = int(self.data[f"pids_{mode}"][index])
        if onehot:
            labels = to_evaluation_onehot(labels)
        return image, labels, pid

    def offsets(self, index: int, mode: str = "validation"):
        """(crop_lo, crop_hi, original_shape) for ``reassemble_to_original``,
        or None where the cache has no offsets."""
        if f"cropHi_{mode}" not in self.data:
            return None
        lo = np.asarray([self.data[f"{n}_{mode}"][index] for n in ("xOffsets", "yOffsets", "zOffsets")],
                        dtype=np.int64)
        hi = np.asarray(self.data[f"cropHi_{mode}"][index], dtype=np.int64)
        shape = np.asarray(self.data[f"origShape_{mode}"][index], dtype=np.int64)
        return lo, hi, shape

    def batch_iterator(self, batch_size: int, mode: str = "train", shuffle: bool = True):
        """(B, D, H, W, 4) images, (B, D, H, W, 3) one-hot labels and the pids."""
        idx = np.arange(self.num_examples(mode))
        if shuffle:
            self.rng.shuffle(idx)
        for b in range(0, len(idx), batch_size):
            items = [self.get(int(i), mode) for i in idx[b:b + batch_size]]
            yield np.stack([it[0] for it in items]), np.stack([it[1] for it in items]), [it[2] for it in items]

    @classmethod
    def from_config(cls, sys_config, exp_config) -> "BratsData":
        f = load_and_maybe_process_data(input_folder=sys_config.brats_root,
                                        preprocessing_folder=sys_config.preproc_folder,
                                        size=tuple(exp_config.image_size[:3]))
        return cls(f, seed=exp_config.data_seed)
