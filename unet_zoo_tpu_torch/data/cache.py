"""The preprocessed caches on disk: HDF5 where ``h5py`` imports, else a
directory of ``.npy`` files.

The LIDC, UZH and BraTS loaders read their cache as a mapping:
``data["train"]["images"]`` (LIDC's groups) or ``data["images_train"]``
(the UZH and BraTS flat keys). An open ``h5py.File`` is one such mapping;
``NpyCache`` is the other: one ``.npy`` file a dataset, a subdirectory a
group, each file opened with ``np.load(..., mmap_mode="r")``, so that a
record is read from disk when it is indexed, as h5py reads it (an ``.npz``
would decompress a whole array on every access). Its arrays are read-only.

Which format: where ``h5py`` imports, HDF5 is written and read, so that a
cache stays shareable with the JAX package; where it does not (the card's
machine has no ``h5py``), the npy directory ``<stem>_npy`` beside the HDF5
path is. An existing cache of either kind is read where it can be. Both are
written atomically, into a temporary sibling that ``os.replace`` moves into
place, so that a killed preprocessing run leaves no half cache behind.

``train_test_split`` is the twin of scikit-learn's for an array and a float
``test_size`` (LIDC's subject split), so preprocessing needs no sklearn.
"""

from __future__ import annotations

import logging
import math
import os
import shutil
from collections.abc import Mapping
from typing import Iterator, Optional, Union

import numpy as np

log = logging.getLogger(__name__)

NPY_SUFFIX = "_npy"

Arrays = Mapping  # nested: name -> array, or name -> Arrays (an HDF5 group)


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def npy_dir(path: str) -> str:
    """The npy directory that stands for the HDF5 cache ``path``."""
    return os.path.splitext(path)[0] + NPY_SUFFIX


def train_test_split(a, test_size: float, random_state: Optional[int] = None):
    """(train, test) as ``sklearn.model_selection.train_test_split(a,
    test_size=test_size, random_state=random_state)`` returns them for an
    array ``a`` and a float ``test_size``: the first ``ceil(test_size *
    n)`` entries of ``RandomState(random_state).permutation(n)`` are the
    test set, the rest the train set. Unseeded where ``random_state`` is
    None, as sklearn is (numpy's global generator)."""
    a = np.asarray(a)
    n = len(a)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size {test_size} leaves an empty split of {n} samples")
    rng = np.random.mtrand._rand if random_state is None else np.random.RandomState(random_state)
    perm = rng.permutation(n)
    return a[perm[n_test:]], a[perm[:n_test]]


class NpyCache(Mapping):
    """A directory of ``.npy`` files read as an HDF5 file is read:
    ``cache["images_train"]``, ``cache["train"]["images"]`` or
    ``cache["train/images"]``, each array memory-mapped read-only (its map
    closes when the array is freed). ``filename`` is the directory."""

    def __init__(self, directory: str):
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"no npy cache at {directory}")
        self.filename = directory

    def __getitem__(self, key: str) -> Union[np.ndarray, "NpyCache"]:
        path = os.path.join(self.filename, *key.split("/"))
        if os.path.isfile(path + ".npy"):
            return np.load(path + ".npy", mmap_mode="r")
        if os.path.isdir(path):
            return NpyCache(path)
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        for name in sorted(os.listdir(self.filename)):
            if name.endswith(".npy"):
                yield name[:-4]
            elif os.path.isdir(os.path.join(self.filename, name)):
                yield name

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, key) -> bool:
        path = os.path.join(self.filename, *str(key).split("/"))
        return os.path.isfile(path + ".npy") or os.path.isdir(path)

    def __repr__(self) -> str:
        return f"NpyCache({self.filename!r})"


def _write_npy_tree(directory: str, arrays: Arrays) -> None:
    os.makedirs(directory)
    for name, value in arrays.items():
        if isinstance(value, Mapping):
            _write_npy_tree(os.path.join(directory, name), value)
        else:
            np.save(os.path.join(directory, name + ".npy"), np.asarray(value))


def _write_hdf5_tree(group, arrays: Arrays) -> None:
    for name, value in arrays.items():
        if isinstance(value, Mapping):
            _write_hdf5_tree(group.create_group(name), value)
        else:
            group.create_dataset(name, data=np.asarray(value))


def _replace(tmp: str, dest: str) -> None:
    """Move ``tmp`` to ``dest``, over an existing file or directory."""
    if os.path.isdir(dest):
        old = f"{dest}.old-{os.getpid()}"
        os.replace(dest, old)
        os.replace(tmp, dest)
        shutil.rmtree(old)
    else:
        os.replace(tmp, dest)


def write_cache(path: str, arrays: Arrays, fmt: Optional[str] = None) -> str:
    """Write ``arrays`` (names to arrays, or to mappings of them for HDF5
    groups) as the cache ``path``: the HDF5 file ``path`` where ``h5py``
    imports (``fmt`` "hdf5"), else the npy directory ``npy_dir(path)``
    (``fmt`` "npy"). Atomic; replaces an older cache at that place.
    Returns what it wrote."""
    fmt = fmt or ("hdf5" if h5py_available() else "npy")
    dest = path if fmt == "hdf5" else npy_dir(path)
    parent = os.path.dirname(os.path.abspath(dest))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(dest)}.tmp-{os.getpid()}")
    if os.path.lexists(tmp):
        shutil.rmtree(tmp) if os.path.isdir(tmp) else os.remove(tmp)
    try:
        if fmt == "hdf5":
            import h5py

            with h5py.File(tmp, "w") as f:
                _write_hdf5_tree(f, arrays)
        elif fmt == "npy":
            _write_npy_tree(tmp, arrays)
        else:
            raise ValueError(f"unknown cache format '{fmt}'")
        _replace(tmp, dest)
    except BaseException:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        elif os.path.lexists(tmp):
            os.remove(tmp)
        raise
    log.info("wrote the %s cache %s", "HDF5" if fmt == "hdf5" else "npy", dest)
    return dest


def find_cache(path: str) -> Optional[str]:
    """The readable cache that stands for ``path``: the HDF5 file where it
    exists and ``h5py`` imports, else the npy directory where it exists,
    else None."""
    if os.path.isfile(path) and h5py_available():
        return path
    if os.path.isdir(npy_dir(path)):
        return npy_dir(path)
    return None


def open_cache(path: str):
    """Open the cache ``path`` names (``find_cache``; an npy directory
    itself also): an ``h5py.File`` or an ``NpyCache``. Raises
    ``FileNotFoundError`` where there is none."""
    found = path if os.path.isdir(path) else find_cache(path)
    if found is None:
        hint = " (an HDF5 file is there, but h5py does not import)" if os.path.isfile(path) else ""
        raise FileNotFoundError(f"no readable cache at {path} or {npy_dir(path)}{hint}")
    if os.path.isdir(found):
        log.info("reading the npy cache %s", found)
        return NpyCache(found)
    import h5py

    log.info("reading the HDF5 cache %s", found)
    return h5py.File(found, "r")


def load_or_build(path: str, build, force_overwrite: bool = False):
    """The open cache for ``path``, after ``build(path)`` where there is no
    readable one (or ``force_overwrite``)."""
    if force_overwrite or find_cache(path) is None:
        build(path)
    return open_cache(path)

