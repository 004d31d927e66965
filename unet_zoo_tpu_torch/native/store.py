"""ctypes bindings for the native batch store (``batchstore.cpp``), the twin
of ``unet_zoo_tpu.native.store``.

``batchstore.cpp`` is the JAX package's source, copied: a flat "UZBS1"
record file, memory-mapped, with a record gather on a C++ thread pool and
an asynchronous prefetch pipeline. It is built at first use with
``g++ -O3 -shared -fPIC -pthread -std=c++17`` into
``unet_zoo_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags, so an edited source is rebuilt; importing this module
builds nothing. A failed build raises with the compiler's error: nothing
falls back to the numpy provider.

``write_store`` converts an array (numpy, memory-mapped or h5py) into a
store; ``NativeBatchProvider`` is the ``BatchProvider`` twin whose records
are gathered one batch ahead on C++ threads, with the same sampling and RNG
stream, so equal seeds give equal batches; ``train_provider_from_h5`` serves
a cache's train split through it (``loader="native"``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().with_name("batchstore.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

# dtype code IS the itemsize (see batchstore.cpp header comment)
_SUPPORTED = {
    np.dtype(np.uint8): 1,
    np.dtype(np.int16): 2,
    np.dtype(np.float32): 4,
    np.dtype(np.int32): 4,
    np.dtype(np.float64): 8,
    np.dtype(np.int64): 8,
}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbatchstore_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (raises with g++'s error where it fails);
    atomic, so a concurrent process sees a whole library or none."""
    lib_path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        raise RuntimeError("batchstore build failed: g++ not found") from None
    if proc.returncode != 0:
        raise RuntimeError(f"batchstore build failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    lib_path = library_path()
    if not lib_path.exists():
        build()
    lib = ctypes.CDLL(str(lib_path))
    lib.bs_open.restype = ctypes.c_void_p
    lib.bs_open.argtypes = [ctypes.c_char_p]
    lib.bs_close.argtypes = [ctypes.c_void_p]
    lib.bs_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.bs_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.bs_prefetcher_new.restype = ctypes.c_void_p
    lib.bs_prefetcher_new.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.bs_prefetcher_submit.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.bs_prefetcher_wait.restype = ctypes.c_void_p
    lib.bs_prefetcher_wait.argtypes = [ctypes.c_void_p]
    lib.bs_prefetcher_free.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


def write_store(path: str, array, dtype=None) -> str:
    """Write an array (numpy, memory-mapped or an h5py dataset) as a UZBS1
    store at ``path``, a chunk of records at a time, cast to ``dtype``
    where given (the LIDC cache's float64 images are stored as the float32
    the batches carry). Atomic: a killed write leaves no store behind."""
    dtype = np.dtype(dtype) if dtype is not None else np.dtype(np.asarray(array[0:1]).dtype)
    if dtype not in _SUPPORTED:
        raise ValueError(f"unsupported dtype {dtype}")
    shape = tuple(array.shape)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(b"UZBS1")
            f.write(bytes([dtype.itemsize, len(shape), 0]))
            f.write(np.asarray(shape, dtype=np.int64).tobytes())
            chunk = max(1, (1 << 26) // max(1, int(np.prod(shape[1:])) * dtype.itemsize))
            for i in range(0, shape[0], chunk):
                f.write(np.ascontiguousarray(np.asarray(array[i:i + chunk], dtype=dtype)).tobytes())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


class BatchStore:
    """A memory-mapped record store with a parallel C++ gather."""

    def __init__(self, path: str, dtype, nthreads: int = 4):
        self._lib = _lib()
        self._h = self._lib.bs_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open batch store {path}")
        n = ctypes.c_int64()
        rb = ctypes.c_int64()
        dims = (ctypes.c_int64 * 8)()
        nd = ctypes.c_int()
        self._lib.bs_info(self._h, ctypes.byref(n), ctypes.byref(rb), dims, ctypes.byref(nd))
        self.num_records = n.value
        self.record_bytes = rb.value
        self.shape = tuple(dims[i] for i in range(nd.value))
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize * int(np.prod(self.shape[1:])) != rb.value:
            self.close()
            raise ValueError(f"dtype {self.dtype} does not match the store's record of {rb.value} bytes")
        self.nthreads = nthreads

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        """The records at ``indices`` (each clamped into range by the library)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx),) + self.shape[1:], dtype=self.dtype)
        self._lib.bs_gather(self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
                            out.ctypes.data_as(ctypes.c_void_p), self.nthreads)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.bs_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class Prefetcher:
    """Asynchronous gathers in FIFO order: ``submit`` index lists; ``wait``
    returns the oldest filled batch as a numpy view, valid until the next
    ``wait``."""

    def __init__(self, store: BatchStore, batch_size: int, depth: int = 3):
        self._lib = store._lib
        self._store = store
        self.batch_size = batch_size
        self._p = self._lib.bs_prefetcher_new(store._h, batch_size, store.nthreads, depth)

    def submit(self, indices: Sequence[int]) -> None:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if len(idx) != self.batch_size:
            raise ValueError(f"{len(idx)} indices for a prefetcher of batch {self.batch_size}")
        self._lib.bs_prefetcher_submit(self._p, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx))

    def wait(self) -> np.ndarray:
        ptr = self._lib.bs_prefetcher_wait(self._p)
        buf = (ctypes.c_char * (self.batch_size * self._store.record_bytes)).from_address(ptr)
        arr = np.frombuffer(buf, dtype=self._store.dtype)
        return arr.reshape((self.batch_size,) + self._store.shape[1:])

    def close(self) -> None:
        if self._p:
            self._lib.bs_prefetcher_free(self._p)
            self._p = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeBatchProvider:
    """The ``BatchProvider`` twin over native stores, with its sampling
    (without replacement across batches, sorted indices, one annotator an
    example) and its RNG stream, the records gathered on C++ threads one
    batch ahead of the consumer. The batch size is fixed."""

    def __init__(
        self,
        image_store: BatchStore,
        label_store: BatchStore,
        indices: np.ndarray,
        batch_size: int,
        add_dummy_dimension: bool = True,
        num_labels_per_subject: int = 1,
        annotator_range: Optional[Sequence[int]] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.X = image_store
        self.y = label_store
        self.indices = np.asarray(indices)
        self.unused_indices = self.indices.copy()
        self.batch_size = batch_size
        self.add_dummy_dimension = add_dummy_dimension
        self.num_labels_per_subject = num_labels_per_subject
        self.annotator_range = (list(annotator_range) if annotator_range is not None
                                else list(range(num_labels_per_subject)))
        self.rng = rng if rng is not None else np.random.default_rng()
        self._px = Prefetcher(image_store, batch_size)
        self._py = Prefetcher(label_store, batch_size)
        self._pending_picks: list = []  # annotator picks, FIFO with the submits
        self._primed = False

    def _sample_indices(self) -> np.ndarray:
        if len(self.unused_indices) < self.batch_size:
            self.unused_indices = self.indices
        picks = self.rng.choice(self.unused_indices, self.batch_size, replace=False)
        self.unused_indices = np.setdiff1d(self.unused_indices, picks)
        return np.sort(picks)

    def _submit_next(self) -> None:
        # every host draw of a batch happens here, in BatchProvider's order
        # (indices, then annotator picks): the prefetcher runs a batch ahead,
        # so drawing the picks in next_batch would interleave them with the
        # next batch's index draw and part the two streams
        idx = self._sample_indices()
        self._px.submit(idx)
        self._py.submit(idx)
        self._pending_picks.append(self.rng.choice(self.annotator_range, size=self.batch_size)
                                   if self.num_labels_per_subject > 1 else None)

    def next_batch(self, batch_size: Optional[int] = None):
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"NativeBatchProvider has a fixed batch size {self.batch_size}, asked for {batch_size}")
        if not self._primed:
            self._submit_next()
            self._primed = True
        self._submit_next()  # keep one batch in flight
        X = np.array(self._px.wait(), dtype=np.float32, copy=True)  # own the buffer
        y = np.array(self._py.wait(), copy=True)
        picks = self._pending_picks.pop(0)
        if picks is not None:
            y = np.stack([y[i, ..., a] for i, a in enumerate(picks)], axis=0)
        if self.add_dummy_dimension:
            X = np.expand_dims(X, axis=-1)
        return X, y.astype(np.int32)

    def close(self) -> None:
        self._px.close()
        self._py.close()
        self.X.close()
        self.y.close()


def train_provider_from_h5(
    data_file,
    batch_size: int,
    *,
    images: str = "train/images",
    labels: str = "train/labels",
    add_dummy_dimension: bool = True,
    num_labels_per_subject: int = 1,
    annotator_range: Optional[Sequence[int]] = None,
    rng: Optional[np.random.Generator] = None,
    image_dtype=np.float32,
) -> NativeBatchProvider:
    """Serve one split of a cache on disk (an open ``h5py.File`` or an
    ``NpyCache``; the name is the JAX package's) through the native store:
    the split's images and labels are converted once into UZBS stores
    beside the cache (``<cache>.<key>.uzbs``), rebuilt where the cache is
    newer, and memory-mapped from then on. The sampling and RNG order are
    ``BatchProvider``'s, so a provider seeded alike yields the same batches."""
    base = data_file.filename
    img_ds, lbl_ds = data_file[images], data_file[labels]
    img_path = f"{base}.{images.replace('/', '.')}.uzbs"
    lbl_path = f"{base}.{labels.replace('/', '.')}.uzbs"
    cache_mtime = os.path.getmtime(base)
    if not os.path.exists(img_path) or os.path.getmtime(img_path) < cache_mtime:
        write_store(img_path, img_ds, dtype=image_dtype)
    if not os.path.exists(lbl_path) or os.path.getmtime(lbl_path) < cache_mtime:
        write_store(lbl_path, lbl_ds)
    img_store = BatchStore(img_path, image_dtype)
    lbl_store = BatchStore(lbl_path, np.dtype(lbl_ds.dtype))
    return NativeBatchProvider(img_store, lbl_store, np.arange(img_store.num_records), batch_size,
                               add_dummy_dimension=add_dummy_dimension, num_labels_per_subject=num_labels_per_subject,
                               annotator_range=annotator_range, rng=rng)


def native_train_provider(data_file, batch_size: Optional[int], resize_to, images: str, labels: str,
                          **kwargs) -> NativeBatchProvider:
    """``loader="native"`` of ``LIDCData`` and ``UZHProstateData``: the
    checks (a cache on disk, no ``resize_to``, a ``batch_size``), then
    ``train_provider_from_h5``."""
    if getattr(data_file, "filename", None) is None:
        raise NotImplementedError("loader='native' serves a cache on disk (an HDF5 file or an npy directory); "
                                  "a mapping of arrays in memory has none")
    if resize_to:
        raise ValueError("loader='native' does not support resize_to")
    if batch_size is None:
        raise ValueError("loader='native' requires batch_size")
    return train_provider_from_h5(data_file, batch_size, images=images, labels=labels, **kwargs)
