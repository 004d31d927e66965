"""Spatial sharding (the mesh's "space" axis), the twin of
``unet_zoo_tpu.parallel.space``.

The JAX package splits the image height (axis 1 of NHWC / NDHWC) over the
"space" devices of each data group and pins the activations to that split
at the conv, pool, resize and reversible outputs, so that XLA exchanges
halos around the convs. PyTorch has no GSPMD, so here each of the ``space``
processes of a data group holds its own rows of every activation and the
ops make the exchanges themselves, with the primitives below, each a
``torch.autograd.Function`` whose backward is the exact transpose of its
forward:

* ``Space.halo(x, rows)``: x with the neighbours' edge rows above and
  below it, zeros at the global top and bottom (a conv then runs 'valid'
  in the height); the backward sends the halo rows' gradients back and adds
  them into the owner's edge rows;
* ``Space.gather(x)``: the whole height, an all-gather over the space
  group; the backward is a reduce-scatter of the sum;
* ``Space.scatter(x)``: this process's rows of a tensor every process holds
  whole; the backward pads with zeros;
* ``Space.own(t)``: the weight of a loss term computed from ``t``: 1 where
  ``t`` is sharded, and where it is replicated 1 on the group's first
  process and 0 elsewhere, so that the sum over the group counts it once.

The rule of the JAX package (``constrain``): a tensor is sharded where its
global height splits evenly over the space group, and replicated
otherwise (a deep pyramid level under the group's size, or an uneven
height such as 3 at UZH 192x192's level 6). The rule reads the global
height, which the local tensor alone does not tell (at space 2 a local
height of 3 is a sharded 6 or a replicated 3): ``Space.shard`` of the
model's input records the global heights of the encoder's ceil-halving
pyramid, keyed by the axes that are never split (W, or H and W in 3D), and
every activation of the models lies on it.

``space_sharding(mesh)`` makes the rule active, around the train step
only, as in JAX: outside it every op runs unsharded, so validation,
evaluation and ``generate_images`` do not change. The ops read the active
``Space`` in the forward (``current``); the backward runs on autograd's
device thread on a card, so whatever runs there holds the ``Space`` it was
given in the forward (the Functions' contexts, ``ops.conv.remat``'s
re-run, ``ReversibleChain``), never the context.

The exchanges go over the mesh's space subgroup (``parallel.mesh``): on
NCCL the halo rows go to the two neighbours by ``batch_isend_irecv``; on
gloo (the CPU, or processes that share one card) by an all-gather of every
process's edge rows, since gloo takes no send or receive of a CUDA tensor.
Gathers are list all-gathers and reduce-scatters on both. Any other backend
raises: there is no fallback.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("space_sharding", default=None)


def shardable(height: int, size: int) -> bool:
    """Whether a global height is split over a space group of ``size``: it
    divides evenly (which keeps it at the group's size or above)."""
    return height >= size and height % size == 0


def rows_of(height: int, size: int, index: int) -> slice:
    """Process ``index``'s rows of a global ``height`` on a space group of
    ``size``: its share where the height is ``shardable``, else all."""
    if not shardable(height, size):
        return slice(0, height)
    n = height // size
    return slice(index * n, (index + 1) * n)


def pyramid(spatial: Sequence[int]) -> list:
    """The encoder's ceil-halving sizes from ``spatial`` down to 1 a side."""
    sizes = [tuple(spatial)]
    while any(s > 1 for s in sizes[-1]):
        sizes.append(tuple(-(-s // 2) for s in sizes[-1]))
    return sizes


@dataclasses.dataclass(eq=False)
class Space:
    """This process's place in its data group's space axis: the subgroup,
    its ``size``, this process's ``index`` in it, the global ranks of the
    neighbours holding the rows above (``up``) and below (``down``), None
    at the edges, and the global heights of the step's activations
    (``heights``, filled by ``shard``)."""

    group: object
    size: int
    index: int
    up: Optional[int]
    down: Optional[int]
    heights: Dict[tuple, int] = dataclasses.field(default_factory=dict)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    # the rule

    def _key(self, t: torch.Tensor) -> tuple:
        if t.ndim not in (4, 5):
            raise ValueError(f"space sharding takes batch-leading NHWC/NDHWC activations (rank 4 or 5), got "
                             f"shape {tuple(t.shape)}")
        return tuple(t.shape[2:-1])

    def global_height(self, t: torch.Tensor) -> int:
        """The global height of activation ``t`` (rank 4 or 5), read from the
        recorded pyramid by its unsplit axes."""
        key = self._key(t)
        if key not in self.heights:
            raise ValueError(f"no activation of unsplit spatial axes {key} is recorded on this step's pyramid "
                             f"{self.heights}: space sharding knows the global height of the model's levels only")
        height = self.heights[key]
        local = height // self.size if shardable(height, self.size) else height
        if t.shape[1] != local:
            raise ValueError(f"activation {tuple(t.shape)}: a global height of {height} is {local} rows a process "
                             f"at space {self.size}")
        return height

    def is_sharded(self, t: torch.Tensor) -> bool:
        return shardable(self.global_height(t), self.size)

    def rows(self, height: int) -> slice:
        """This process's rows of a global height (all of them where it stays replicated)."""
        return rows_of(height, self.size, self.index)

    def global_spatial(self, t: torch.Tensor) -> tuple:
        return (self.global_height(t), *t.shape[2:-1])

    def shard(self, *ts: torch.Tensor):
        """This process's rows of tensors that hold the whole height (the
        model's input, its labels, the global z noise), axis 1 split by the
        rule; the first records the step's pyramid from its spatial shape
        (its axes 1 to -2, a channel axis last). Differentiable (``scatter``)."""
        if not self.heights:
            for size in pyramid(ts[0].shape[1:-1]):
                self.heights.setdefault(size[1:], size[0])
        out = tuple(_Scatter.apply(t, self, self.rows(t.shape[1])) if shardable(t.shape[1], self.size) else t
                    for t in ts)
        return out if len(out) > 1 else out[0]

    def constrain(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the rule's layout: a replicated activation whose global
        height splits evenly becomes this process's rows."""
        if x.shape[1] == self.heights.get(self._key(x)) and shardable(x.shape[1], self.size):
            return self.scatter(x)
        self.global_height(x)  # checks the layout
        return x

    # the primitives

    def halo(self, x: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """Sharded ``x`` with ``rows`` rows of each neighbour above and below
        (zeros at the global top and bottom): local height + 2 ``rows``."""
        return _Halo.apply(x, self, rows)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Sharded ``x`` whole: the space group's rows in order."""
        return _Gather.apply(x, self)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``x``, which every process of the group holds whole."""
        return _Scatter.apply(x, self, self.rows(x.shape[1]))

    def own(self, t: torch.Tensor) -> float:
        """The weight of a loss term computed from ``t``: 1.0 where ``t`` is a
        sharded activation; where it is replicated (or not an activation, as
        a latent vector or a parameter norm) 1.0 on the group's first process
        and 0.0 on the others."""
        if t.ndim in (4, 5) and self.is_sharded(t):
            return 1.0
        return 1.0 if self.index == 0 else 0.0

    # the collectives

    def _exchange(self, a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sends ``a`` up and ``b`` down; returns (the ``b`` of the process
        above, the ``a`` of the process below), zeros at the edges."""
        a, b = a.contiguous(), b.contiguous()
        from_up, from_down = torch.zeros_like(b), torch.zeros_like(a)
        backend = self.backend
        if backend == "nccl":
            ops = []
            if self.up is not None:
                ops += [dist.P2POp(dist.isend, a, self.up, self.group), dist.P2POp(dist.irecv, from_up, self.up,
                                                                                  self.group)]
            if self.down is not None:
                ops += [dist.P2POp(dist.isend, b, self.down, self.group),
                        dist.P2POp(dist.irecv, from_down, self.down, self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        elif backend == "gloo":
            edges = torch.stack([a, b])
            every = [torch.empty_like(edges) for _ in range(self.size)]
            dist.all_gather(every, edges, group=self.group)
            if self.up is not None:
                from_up = every[self.index - 1][1]
            if self.down is not None:
                from_down = every[self.index + 1][0]
        else:
            raise RuntimeError(f"space sharding exchanges halos over NCCL or gloo, not {backend}")
        return from_up, from_down

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def _reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        parts = [p.contiguous() for p in g.chunk(self.size, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.group)
        return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Space, rows: int) -> torch.Tensor:
        if x.shape[1] < rows:
            raise ValueError(f"a halo of {rows} rows needs as many local rows, got {tuple(x.shape)}")
        ctx.sp, ctx.rows = sp, rows
        above, below = sp._exchange(x[:, :rows], x[:, -rows:])
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        r = ctx.rows
        g = g.contiguous()
        to_up, to_down = ctx.sp._exchange(g[:, :r], g[:, -r:])
        gx = g[:, r:-r].clone()
        gx[:, :r] += to_up
        gx[:, -r:] += to_down
        return gx, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Space) -> torch.Tensor:
        ctx.sp = sp
        return sp._all_gather(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.sp._reduce_scatter(g), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, sp: Space, rows: slice) -> torch.Tensor:
        ctx.height, ctx.rows = x.shape[1], rows
        return x[:, rows].clone()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        gx = g.new_zeros((g.shape[0], ctx.height, *g.shape[2:]))
        gx[:, ctx.rows] = g
        return gx, None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``t`` over ``group``; the backward is the sum of the
    gradients over the group, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``t`` over the process ``group``."""
    return _AllReduceSum.apply(t, group)


# the context


def current() -> Optional[Space]:
    """The active ``Space`` of this thread, None outside ``space_sharding``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(sp: Optional[Space]):
    """Makes ``sp`` the active ``Space`` (None: none) inside the block: the
    backward's re-runs enter the forward's."""
    token = _ACTIVE.set(sp)
    try:
        yield sp
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def space_sharding(mesh):
    """Spatial sharding over ``mesh``'s space axis inside the block, which
    yields the ``Space``; a no-op yielding None where ``mesh`` is None or
    its space axis is 1."""
    if mesh is None or mesh.space <= 1:
        yield None
        return
    index = mesh.rank % mesh.space
    sp = Space(mesh.space_group, mesh.space, index, mesh.rank - 1 if index > 0 else None,
               mesh.rank + 1 if index < mesh.space - 1 else None)
    with activate(sp):
        yield sp


def constrain(x):
    """Pins a batch-leading (B, H, ...) activation to the ("data", "space")
    layout while ``space_sharding`` is active: a replicated activation whose
    global height splits evenly becomes this process's rows. Rank below 3
    passes through; rank 3 or above 5 raises, as in the JAX package. The
    identity outside the context."""
    sp = current()
    if sp is None or not hasattr(x, "ndim") or x.ndim < 3:
        return x
    if x.ndim not in (4, 5):
        raise ValueError(f"space_sharding constrain() expects batch-leading NHWC/NDHWC activations (rank 4 or 5); "
                         f"got rank {x.ndim} shape {tuple(x.shape)}")
    return sp.constrain(x)


def global_spatial(t: torch.Tensor) -> tuple:
    """The spatial shape (axes 1 to -2) of activation ``t``, its height
    global while space sharding is active."""
    sp = current()
    return tuple(t.shape[1:-1]) if sp is None else sp.global_spatial(t)


def own(t: torch.Tensor) -> float:
    """``Space.own`` of the active ``Space``; 1.0 outside the context."""
    sp = current()
    return 1.0 if sp is None else sp.own(t)


def mean(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The global mean of a per-pixel map ``t`` laid out as activation
    ``like``: ``t.mean()`` outside the context, else the local sum over
    the global count, weighted by ``own``, so that the group's sum is the
    mean."""
    sp = current()
    if sp is None:
        return t.mean()
    count = t.numel() * (sp.size if sp.is_sharded(like) else 1)
    return t.sum() * sp.own(like) / count


def spatial_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of NHWC ``t`` over its spatial axes, (B, C): over the whole
    height (a sum over the space group) while space sharding is active."""
    sp = current()
    if sp is None or not sp.is_sharded(t):
        return t.mean((1, 2))
    return all_reduce_sum(t.sum((1, 2)), sp.group) / (sp.global_height(t) * t.shape[2])


# the resizes along the height


@functools.lru_cache(maxsize=256)
def _matrix(n_in: int, n_out: int, mode: str, align_corners: Optional[bool]) -> torch.Tensor:
    """(n_out, n_in) float32: torch's 1D interpolation of ``mode`` as a
    matrix (each output row's weights, read off ``F.interpolate`` of the
    identity)."""
    eye = torch.eye(n_in)[None]
    kw = {} if mode == "nearest" else {"align_corners": align_corners}
    return F.interpolate(eye, size=n_out, mode=mode, **kw)[0].t().contiguous()


@functools.lru_cache(maxsize=256)
def _rows_of_matrix(n_in: int, n_out: int, mode: str, align_corners: Optional[bool], rows: Tuple[int, int],
                    cols: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """Rows ``rows`` of ``_matrix`` on ``device``, its columns ``cols`` of
    the input's global rows with a zero row beyond each end (-1 and
    ``n_in``: the zero halo at the global top and bottom)."""
    m = F.pad(_matrix(n_in, n_out, mode, align_corners)[slice(*rows)], (1, 1))
    return m[:, cols[0] + 1:cols[1] + 1].to(device)


def resize_height(x: torch.Tensor, height: int, mode: str, align_corners: Optional[bool] = None) -> torch.Tensor:
    """Activation ``x`` resized along its height to the global ``height``
    ("linear" or "nearest"), in this process's layout of the output: its
    rows of the interpolation matrix applied to the input rows they read,
    from x and a 1-row halo where those are enough (a 2x upsample), else
    from the gathered input. The product is taken in float32."""
    sp = current()
    n_in = sp.global_height(x)
    rows = sp.rows(height)
    used = _matrix(n_in, height, mode, align_corners)[rows].abs().sum(0).nonzero()
    first, last = int(used[0]), int(used[-1]) + 1
    start = 0
    if sp.is_sharded(x):
        own = sp.rows(n_in)
        if first >= own.start - 1 and last <= own.stop + 1:
            x, start = sp.halo(x, 1), own.start - 1
        else:
            x = sp.gather(x)
    m = _rows_of_matrix(n_in, height, mode, align_corners, (rows.start, rows.stop), (start, start + x.shape[1]),
                        x.device)
    return _along(x, 1, m)


def resize_axis(x: torch.Tensor, axis: int, size: int, mode: str, align_corners: Optional[bool] = None
                ) -> torch.Tensor:
    """``x`` resized along an unsplit ``axis`` to ``size`` ("linear" or
    "nearest"): the interpolation matrix's product, in float32 (a fold of
    the height into the batch would meet ``F.interpolate``'s 1D kernels,
    whose CUDA backward is the slower by far at the U-Net's shapes:
    ``tools/torch_space_profile.py`` times the two, PERF.md)."""
    n_in = x.shape[axis]
    if n_in == size:
        return x
    return _along(x, axis, _rows_of_matrix(n_in, size, mode, align_corners, (0, size), (0, n_in), x.device))


def _along(x: torch.Tensor, axis: int, m: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) ``m`` applied along ``axis`` of ``x`` in float32, cast back."""
    return torch.matmul(x.float().movedim(axis, -1), m.t()).movedim(-1, axis).to(x.dtype)
