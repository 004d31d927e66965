"""Data parallelism over ``torch.distributed``, the twin of ``unet_zoo_tpu.parallel.mesh``.

The JAX package jits the one-device step over a ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives. PyTorch has no GSPMD, so here one
process drives one card (or the CPU), the process group is the mesh's
"data" axis, and the ``Trainer`` makes each collective explicit: BatchNorm's
batch statistics all-reduced over the group (``sync_batch_norm``), the
gradients all-reduced as one flat buffer after the backward, the loss before
the plateau scheduler. Every process builds its state from the same seed,
so parameters, optimizer state and the state's generator start equal on
every rank (``replicated`` checks it), as the JAX package builds its
replicated state from identically seeded processes. A step at any world
size then computes the one-process step on the global batch, up to float32
summation order.

The group is gloo on the CPU and NCCL on the cards. Ranks that share one
card must ask for gloo (``init_distributed(backend="gloo")``): NCCL refuses
two ranks on one card, and gloo all-reduces CUDA tensors through host
copies. A process that trains alone holds ``local_mesh``, where every
collective returns at once.

The "space" axis (``parallel/space.py``): at space K > 1 the world is data
x K processes, and processes ``d*K ... d*K+K-1`` form data group ``d``,
which shares one batch and splits its height over them (``space_group``,
one ``dist.new_group`` each, created by every process in the same order).
Each process's gradient is then its rows' part of its data group's: the
gradients are summed over the world and divided by ``data``, a sum over
the space group and a mean over the data axis (``all_reduce_grads_``,
``mean_over_processes``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from unet_zoo_tpu_torch.models.registry import resolve_device
from unet_zoo_tpu_torch.ops.norm import BatchNorm
from unet_zoo_tpu_torch.ops.reversible import ReversibleSequence

log = logging.getLogger(__name__)

# the group's collective and barrier timeout, the JAX package's barrier
# timeout: process 0 validates alone while the others wait in the next
# step's first all-reduce
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a ("data", "space") mesh: ``rank`` of
    ``world`` = data x space processes, its ``device``, the process
    ``group`` (None in one process without ``init_distributed``) and, at
    space > 1, ``space_group``, the processes of its data group."""

    data: int
    space: int
    rank: int
    world: int
    group: Optional[object]
    device: torch.device
    space_group: Optional[object] = None


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda", backend: Optional[str] = None) -> bool:
    """Joins the process group: call once in every process, before
    ``make_mesh``. ``coordinator_address`` is process 0's HOST:PORT (a TCP
    rendezvous), the same in every process. ``backend`` defaults to gloo
    for the CPU and NCCL for a card, whatever the cards this host sees (one
    node of several, or one card made visible to each rank); ranks that
    share one card pass "gloo". Returns True if the group is up (or
    already was), False where no multi-process launch was asked for (one
    process). A launch asked for but incomplete, or that fails, raises: a
    misconfigured run must not train alone."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process launch needs the coordinator's HOST:PORT, the number of processes and "
                         f"this process's id in every process; got {coordinator_address!r}, {num_processes!r}, "
                         f"{process_id!r}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    log.info("process %d of %d joined a %s group at %s", process_id, num_processes, backend, coordinator_address)
    return True


def process_index() -> int:
    """This process's rank in the group, 0 without one (``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(data: Optional[int] = None, space: int = 1, device=None) -> Mesh:
    """The mesh over every process of the group (one process without one):
    ``data`` x ``space`` must be the world size (``data`` defaults to what
    is left of it). The device is ``device``, by default the card
    ``cuda:{rank % device_count}``, which becomes the current one; "cpu"
    where asked for. At space > 1 every process creates every data group's
    space subgroup, in order, and keeps its own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = process_index()
    if space < 1 or world % space:
        raise ValueError(f"a space axis of {space} does not divide the {world} processes of this run")
    data = world // space if data is None else data
    if data * space != world:
        raise ValueError(f"a mesh of data={data} x space={space} needs {data * space} processes, one a card; "
                         f"this run has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    space_group = None
    if space > 1:
        for d in range(data):
            group = dist.new_group(list(range(d * space, (d + 1) * space)), timeout=TIMEOUT)
            if d == rank // space:
                space_group = group
        # one collective of the whole subgroup first: NCCL then builds its
        # communicator before the halos' point-to-point exchanges use it
        dist.all_reduce(torch.zeros(1, device=dev), group=space_group)
    return Mesh(data, space, rank, world, dist.group.WORLD if dist.is_initialized() else None, dev, space_group)


def local_mesh(device=None) -> Mesh:
    """The mesh of this process alone, with no group (``device`` as
    ``models.registry.resolve_device`` reads it): the one-process step."""
    return Mesh(1, 1, 0, 1, None, resolve_device(device))


def batch_spec(mesh: Mesh, batch: int) -> slice:
    """The rows of a global batch of ``batch`` that this process holds (its
    data group's). Raises where the batch does not split evenly over the
    data axis (the JAX package's sharded step fails there too). A data
    group's processes hold the same rows: each keeps its share of their
    height under ``space_sharding`` (``Space.shard``)."""
    if batch % mesh.data:
        raise ValueError(f"a global batch of {batch} does not split evenly over {mesh.data} data-parallel ranks")
    rows = batch // mesh.data
    first = (mesh.rank // mesh.space) * rows
    return slice(first, first + rows)


# the JAX package's name for the labels' rows, kept so that scripts written
# against it run: labels split over the batch axis as the images do
shard_label_spec = batch_spec


def shard_batch(mesh: Mesh, x):
    """This process's rows of the global batch ``x`` (an array or a tensor):
    its data group's images, whole (the ``Trainer`` warps them before it
    keeps its rows of their height)."""
    return x[batch_spec(mesh, len(x))]


def host_to_global(mesh: Mesh, x) -> torch.Tensor:
    """This process's rows of the host batch ``x``, which every process
    holds in full, on the mesh's device (from page-locked memory on a card,
    so the copy does not wait for the device): the JAX package's upload,
    kept under its name; the ``Trainer`` uploads ``shard_batch``'s rows
    itself."""
    t = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, np.asarray(x))))
    if mesh.device.type == "cuda":
        return t.pin_memory().to(mesh.device, non_blocking=True)
    return t.to(mesh.device)


def barrier(name: str = "") -> None:
    """Blocks until every process of the group reaches a barrier (a no-op
    in one process): the fence around process 0's file writes. ``name``
    labels it in the log."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        log.debug("barrier %s", name)
        dist.barrier()


def all_reduce_mean_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` becomes its sum over each data group's space processes and
    its mean over the data axis, in place: the sum over the world, divided
    by ``data`` (each process holds its rows' part of its data group's
    value). At world 1, ``t`` as it is."""
    if mesh.world == 1:
        return t
    dist.all_reduce(t, group=mesh.group)
    return t.div_(mesh.data)


def all_reduce_grads_(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Every gradient of ``params`` becomes the global batch's (the sum
    over the space axis, the mean over the data axis, ``all_reduce_mean_``):
    one all-reduce of them all in one flat buffer. At world 1 nothing is
    copied."""
    if mesh.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_mean_(mesh, torch._utils._flatten_dense_tensors(grads))
    for g, mean in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(mean)


def mean_over_processes(mesh: Mesh, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The detached scalars ``values`` (each process's part of its data
    group's), each the global batch's (one all-reduce in float32,
    ``all_reduce_mean_``). At world 1, ``values`` detached."""
    values = {k: v.detach() for k, v in values.items()}
    if mesh.world == 1:
        return values
    means = all_reduce_mean_(mesh, torch.stack([v.float() for v in values.values()]))
    return {k: m.to(v.dtype) for (k, v), m in zip(values.items(), means)}


def replicated(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> bool:
    """Whether every process holds process 0's ``tensors`` bit for bit (on
    the mesh's device). Every process must call it: it broadcasts process
    0's bytes and all-reduces the verdict."""
    if mesh.group is None or mesh.world == 1:
        return True
    flat = torch.cat([t.detach().to(mesh.device).contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    same = torch.tensor([int(torch.equal(ref, flat))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(same.item())


def sync_batch_norm(module: torch.nn.Module, group) -> torch.nn.Module:
    """Sets ``group`` on every ``BatchNorm`` and ``ReversibleSequence`` in
    ``module`` (the idiom of ``nn.SyncBatchNorm.convert_sync_batchnorm``):
    in train mode their batch statistics are then those of the group's
    global batch, the twin of the JAX BatchNorm's ``axis_name``. With the
    whole mesh's group at space > 1 the sums and the count take every
    process's rows: a replicated level's ``space`` copies scale both alike.
    Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, ReversibleSequence)):
            m.process_group = group
    return module
