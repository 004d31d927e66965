"""Native (C++) runtime of the port: ``batchstore.cpp``, a memory-mapped
flat record store with a multithreaded gather and prefetch, built with g++
at first use (``store``)."""

from unet_zoo_tpu_torch.native.store import (
    BatchStore,
    NativeBatchProvider,
    Prefetcher,
    native_available,
    train_provider_from_h5,
    write_store,
)

__all__ = [
    "BatchStore",
    "NativeBatchProvider",
    "Prefetcher",
    "native_available",
    "train_provider_from_h5",
    "write_store",
]
