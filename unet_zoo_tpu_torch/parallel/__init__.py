"""Parallelism of the PyTorch port, the twin of ``unet_zoo_tpu.parallel``:
data parallelism over a ``torch.distributed`` group, one process a card
(``mesh.py``), and the spatial "space" axis, each data group's image height
split over its processes (``space.py``).

``space.py`` is a leaf that the ops and models import; ``mesh.py`` sits
above them (it converts their BatchNorms and resolves the device through the
model registry), so its names load on first use rather than with the
package: importing ``parallel.space`` from an op then never pulls in
``mesh.py`` half-way through the op's own import.
"""

import importlib

from unet_zoo_tpu_torch.parallel.space import constrain, space_sharding

_MESH = ("barrier", "batch_spec", "host_to_global", "init_distributed", "make_mesh", "replicated", "shard_batch",
         "shard_label_spec")

__all__ = [*_MESH, "constrain", "space_sharding"]


def __getattr__(name):
    if name in _MESH:
        return getattr(importlib.import_module("unet_zoo_tpu_torch.parallel.mesh"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
