"""Parallelism of the PyTorch port, the twin of ``unet_zoo_tpu.parallel``:
data parallelism over a ``torch.distributed`` group, one process a card
(``mesh.py``); the spatial "space" axis at 1 only (``space.py``)."""

from unet_zoo_tpu_torch.parallel.mesh import (
    barrier,
    batch_spec,
    host_to_global,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
    shard_label_spec,
)

__all__ = [
    "barrier",
    "host_to_global",
    "init_distributed",
    "make_mesh",
    "batch_spec",
    "shard_batch",
    "replicated",
    "shard_label_spec",
]
