"""The port's native batch store (``unet_zoo_tpu_torch.native``) against the
JAX package's, both built with g++ here.

* the port's ``batchstore.cpp`` is the JAX source, byte for byte, built
  into ``_build/`` under a hash of the source and flags; a failed build
  raises with the compiler's error, and ``loader="native"`` raises with it
  (no fallback to the numpy provider);
* twins of the JAX ``tests/test_native.py`` cases: roundtrip, dtypes, a
  gather fuzz, the prefetcher's order and buffers, the provider's epoch,
  corrupt stores, clamped indices, the stores rebuilt under a newer cache;
* a store written by one package is read by the other;
* ``LIDCData(loader="native")`` and ``UZHProstateData(loader="native")``
  over an HDF5 cache and over an npy cache: the batch stream bit-identical
  to the JAX native provider's and to the ``BatchProvider``'s at equal seeds.
"""

import os
import sys
import time

import h5py
import numpy as np
import pytest

from unet_zoo_tpu.data.lidc import LIDCData as JaxLIDCData
from unet_zoo_tpu.data.uzh import UZHProstateData as JaxUZHData
from unet_zoo_tpu.native import store as jax_store
from unet_zoo_tpu_torch.data import LIDCData, UZHProstateData, cache, synthetic
from unet_zoo_tpu_torch.native import BatchStore, NativeBatchProvider, Prefetcher, native_available, write_store
from unet_zoo_tpu_torch.native import store

SIZE = 16


def _store(tmp_path, arr, name="a.bin", nthreads=4):
    path = str(tmp_path / name)
    write_store(path, arr)
    return BatchStore(path, arr.dtype, nthreads=nthreads)


def test_source_is_the_jax_copy_built_under_a_hash():
    with open(store.SOURCE, "rb") as f, open(jax_store._SRC, "rb") as g:
        assert f.read() == g.read()
    assert native_available()
    path = store.library_path()
    assert path.parent == store.BUILD_DIR and path.name.startswith("libbatchstore_") and path.exists()
    assert store.BUILD_DIR.name == "_build" and store.BUILD_DIR.parent.name == "unet_zoo_tpu_torch"
    assert not list(store.SOURCE.parent.glob("*.so"))


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A source that does not compile: ``build`` raises with g++'s error, and
    ``loader="native"`` raises it instead of serving the numpy provider."""
    bad = tmp_path / "batchstore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(store, "SOURCE", bad)
    monkeypatch.setattr(store, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)batchstore build failed.*error"):
        store.build()
    store._lib.cache_clear()
    try:
        assert not native_available()
        path = synthetic.make_lidc_cache(str(tmp_path / "lidc.hdf5"), (4, 1, 1), SIZE)
        with pytest.raises(RuntimeError, match="batchstore build failed"):
            LIDCData(h5py.File(path, "r"), loader="native", batch_size=2)
    finally:
        store._lib.cache_clear()


def test_roundtrip_gather(tmp_path):
    arr = np.random.default_rng(0).standard_normal((20, 8, 8)).astype(np.float32)
    s = _store(tmp_path, arr)
    assert s.shape == (20, 8, 8) and s.num_records == 20
    np.testing.assert_array_equal(s.gather([3, 7, 19, 0]), arr[[3, 7, 19, 0]])
    s.close()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64, np.int16, np.int32, np.int64])
def test_dtypes(tmp_path, dtype):
    arr = np.random.default_rng(1).uniform(0, 100, (10, 4, 4)).astype(dtype)
    s = _store(tmp_path, arr, name=f"d_{np.dtype(dtype).name}.bin")
    np.testing.assert_array_equal(s.gather([0, 9]), arr[[0, 9]])
    s.close()
    with pytest.raises(ValueError, match="unsupported"):
        write_store(str(tmp_path / "b.bin"), np.zeros((2, 2), np.float16))


def test_gather_fuzz_many_threads(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((100, 16, 16, 4)).astype(np.float32)
    s = _store(tmp_path, arr, nthreads=8)
    for _ in range(10):
        idx = rng.integers(0, 100, size=32)
        np.testing.assert_array_equal(s.gather(idx), arr[idx])
    s.close()


def test_prefetcher_order_and_buffers(tmp_path):
    arr = np.arange(50, dtype=np.float32).reshape(50, 1)
    s = _store(tmp_path, arr)
    p = Prefetcher(s, batch_size=4, depth=3)
    batches = [[0, 1, 2, 3], [10, 11, 12, 13], [40, 41, 42, 43], [7, 8, 9, 10]]
    for b in batches:
        p.submit(b)
    for b in batches:  # FIFO
        np.testing.assert_array_equal(p.wait()[:, 0], np.asarray(b, np.float32))
    with pytest.raises(ValueError, match="prefetcher of batch 4"):
        p.submit([1, 2])
    p.close()
    p = Prefetcher(s, batch_size=2, depth=2)
    for i in range(6):
        p.submit([i, i + 1])
    for i in range(6):  # each wait's view holds its own batch
        np.testing.assert_array_equal(p.wait()[:, 0], [i, i + 1])
    p.close()
    s.close()


def test_provider_epoch(tmp_path):
    rng = np.random.default_rng(0)
    n = 16
    X = rng.standard_normal((n, 8, 8)).astype(np.float32)
    y = rng.integers(0, 2, (n, 8, 8, 4)).astype(np.uint8)
    bp = NativeBatchProvider(_store(tmp_path, X, "x.bin"), _store(tmp_path, y, "y.bin"), np.arange(n), batch_size=4,
                             num_labels_per_subject=4, rng=np.random.default_rng(0))
    seen = set()
    for _ in range(4):  # one epoch without replacement
        xb, yb = bp.next_batch()
        assert xb.shape == (4, 8, 8, 1) and yb.shape == (4, 8, 8) and yb.dtype == np.int32
        for row in xb[..., 0]:
            matches = np.where(np.abs(X - row).sum(axis=(1, 2)) < 1e-6)[0]
            assert len(matches) == 1
            seen.add(int(matches[0]))
    assert len(seen) == n
    with pytest.raises(ValueError, match="fixed batch size"):
        bp.next_batch(3)
    bp.close()


def test_corrupt_store_rejected(tmp_path):
    good = np.arange(24, dtype=np.float32).reshape(4, 6)
    path = str(tmp_path / "c.bin")
    write_store(path, good)
    raw = bytearray(open(path, "rb").read())
    for name, (pos, value) in {"ndim": (6, 255), "dtype": (5, 7)}.items():
        bad = bytearray(raw)
        bad[pos] = value
        (tmp_path / f"bad_{name}.bin").write_bytes(bytes(bad))
        with pytest.raises(OSError):
            BatchStore(str(tmp_path / f"bad_{name}.bin"), np.float32)
    (tmp_path / "trunc.bin").write_bytes(bytes(raw[:-8]))
    with pytest.raises(OSError):
        BatchStore(str(tmp_path / "trunc.bin"), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        BatchStore(path, np.float64)


def test_gather_clamps_out_of_range_indices(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = _store(tmp_path, arr, name="clamp.bin").gather(np.array([-5, 0, 99], dtype=np.int64))
    np.testing.assert_array_equal(out, arr[[0, 0, 2]])


def test_stores_written_by_one_package_read_by_the_other(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((9, 5, 3)).astype(np.float32)
    write_store(str(tmp_path / "port.bin"), arr)
    jax_store.write_store(str(tmp_path / "jax.bin"), arr)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    idx = [8, 0, 4, 4]
    np.testing.assert_array_equal(jax_store.BatchStore(str(tmp_path / "port.bin"), np.float32).gather(idx), arr[idx])
    np.testing.assert_array_equal(BatchStore(str(tmp_path / "jax.bin"), np.float32).gather(idx), arr[idx])


@pytest.mark.parametrize("fmt", ["hdf5", "npy"])
def test_stores_rebuilt_under_a_newer_cache(tmp_path, fmt):
    """The flat stores beside a cache are rebuilt where the cache is newer,
    next to the HDF5 file or the npy directory; the float64 images stream
    into a float32 store."""
    path = str(tmp_path / "cache.hdf5")

    def first_batch(mul):
        written = cache.write_cache(path, {"train": {
            "images": np.arange(40, dtype=np.float64).reshape(10, 2, 2) * mul,
            "labels": (np.arange(40, dtype=np.uint8) % 2).reshape(10, 2, 2) * mul}}, fmt=fmt)
        now = time.time() + 2 * mul
        os.utime(written, (now, now))
        data = cache.NpyCache(written) if fmt == "npy" else h5py.File(written, "r")
        p = store.train_provider_from_h5(data, 4, num_labels_per_subject=1, rng=np.random.default_rng(0))
        try:
            return p.next_batch()
        finally:
            p.close()

    x1, y1 = first_batch(1)
    assert x1.dtype == np.float32 and x1.max() <= 39.0
    assert os.path.exists(f"{path if fmt == 'hdf5' else cache.npy_dir(path)}.train.images.uzbs")
    x2, y2 = first_batch(3)
    np.testing.assert_allclose(x2, x1 * 3)
    np.testing.assert_array_equal(y2, y1 * 3)


def _stream(provider, n, batch):
    return [provider.next_batch(batch) for _ in range(n)]


def _same_stream(a, b):
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


@pytest.mark.parametrize("fmt", ["hdf5", "npy"])
def test_lidc_native_batches_are_the_jax_and_h5py_ones(tmp_path, monkeypatch, fmt):
    """``LIDCData(loader="native")`` over either cache: the batch stream of
    the JAX native provider and of the h5py-loader provider at equal seeds
    (an epoch and a half, so the without-replacement refill is crossed)."""
    arrays = synthetic.lidc_splits((10, 2, 2), SIZE, seed=6)
    h5 = cache.write_cache(str(tmp_path / "lidc.hdf5"), arrays, fmt="hdf5")
    kw = dict(annotator_range=(0, 2, 3), seed=7)
    want = _stream(JaxLIDCData(h5py.File(h5, "r"), loader="native", batch_size=4, **kw).train, 4, 4)
    _same_stream(_stream(LIDCData(h5py.File(h5, "r"), **kw).train, 4, 4), want)
    if fmt == "npy":
        monkeypatch.setitem(sys.modules, "h5py", None)
    data = LIDCData(cache.open_cache(cache.write_cache(str(tmp_path / "port.hdf5"), arrays)) if fmt == "npy"
                    else h5py.File(h5, "r"), loader="native", batch_size=4, **kw)
    assert isinstance(data.train, NativeBatchProvider)
    _same_stream(_stream(data.train, 4, 4), want)
    assert np.array_equal(data.test.images[0], arrays["test"]["images"][0])
    data.train.close()


def test_uzh_native_batches_are_the_jax_ones(tmp_path, monkeypatch):
    arrays = synthetic.uzh_arrays((9, 2, 2), SIZE, seed=8)
    h5 = cache.write_cache(str(tmp_path / "uzh.hdf5"), arrays, fmt="hdf5")
    want = _stream(JaxUZHData(h5py.File(h5, "r"), loader="native", batch_size=3, seed=2).train, 5, 3)
    monkeypatch.setitem(sys.modules, "h5py", None)
    npc = cache.open_cache(cache.write_cache(str(tmp_path / "port.hdf5"), arrays))
    _same_stream(_stream(UZHProstateData(npc, loader="native", batch_size=3, seed=2).train, 5, 3), want)
    _same_stream(_stream(UZHProstateData(npc, seed=2).train, 5, 3), want)
    for kwargs, error in (({"batch_size": None}, ValueError), ({"resize_to": (8, 8), "batch_size": 3}, ValueError)):
        with pytest.raises(error):
            UZHProstateData(npc, loader="native", **kwargs)
    with pytest.raises(NotImplementedError, match="cache on disk"):
        UZHProstateData(arrays, loader="native", batch_size=3)
