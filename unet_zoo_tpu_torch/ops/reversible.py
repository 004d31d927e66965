"""Reversible conv sequences, the twin of ``unet_zoo_tpu.ops.reversible`` (2D NHWC and 3D NDHWC).

RevPHiSeg's memory lever (arXiv:2008.06999, after revtorch): the C channels
split into two halves and each coupling block computes

    y1 = x1 + f(x2),    y2 = x2 + g(y1),

where f and g are conv3x3(x3) + BatchNorm + ReLU on C/2 channels (``_fg``). The
backward reconstructs each block's input from its output,

    x2 = y2 - g(y1),    x1 = y1 - f(x2),

and runs f and g again for their vector-Jacobian products, so a sequence
keeps only its output and its parameters for the backward, whatever its
depth (``ReversibleChain``). The reconstruction is exact up to floating
point, as in the JAX package; the error grows with depth and is largest in
bf16.

BatchNorm makes the blocks carry state: in train mode f and g normalise
with the batch's float32 statistics (so the inverse recomputes the same
function) and return them; ``ReversibleSequence`` folds them into its
running statistics once a step (momentum 0.01, the unbiased variance). In
eval mode it runs the plain chain on the running statistics. Where a
sequence's ``process_group`` is set (``parallel.mesh.sync_batch_norm``),
the train-mode statistics are those of the group's global batch
(``norm.group_moments``), in the forward and in the backward's re-runs
alike, so every rank reconstructs with the same statistics. Under spatial
sharding (``parallel/space.py``) f and g take a 1-row halo of a sharded
input; ``ReversibleChain`` holds the forward's ``Space`` and its backward's
reconstruction runs the exchanges again with it, on whatever thread
autograd runs it.

The JAX package packs the halves to rank 3 and scans over the blocks to fix
a TPU's lane padding and scheduling (``_pack``, ``lax.scan``); a GPU needs
neither, so the blocks here are a Python loop over channels-last halves.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_zoo_tpu_torch.ops import init as init_lib
from unet_zoo_tpu_torch.ops.conv import ConvBNAct, Tensors, _concat, _ZeroGrad, remat
from unet_zoo_tpu_torch.ops.norm import group_moments
from unet_zoo_tpu_torch.parallel import space as space_lib

BN_EPS = 1e-3
MOMENTUM = 0.01  # torch style: the weight of the new batch statistic

FG = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # kernel, bias, scale, shift
Stats = Tuple[torch.Tensor, torch.Tensor]  # mean, variance


def _fg(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
        ema: Optional[Stats] = None, group=None, sp=None) -> Tuple[torch.Tensor, Stats]:
    """The coupling function on NHWC or NDHWC ``x``: conv3x3(x3) with operands in
    ``x.dtype``, the bias added in float32 with an exact zero gradient (the
    JAX package stops it; Adam still decays it), BatchNorm in float32 (float64
    for a float64 ``x``; eps 1e-3), ReLU, cast back to ``x.dtype``. In train
    mode (``ema`` None) it normalises with the batch's mean and
    ``max(E[y^2] - E[y]^2, 0)`` and returns (out, (mean, unbiased
    variance)); else it normalises with ``ema`` and returns it. With a
    process ``group`` the train-mode statistics are the group's; with a
    ``Space`` ``sp`` a sharded x takes a 1-row halo. It touches no buffer,
    so the backward can run it again."""
    conv = F.conv2d if x.ndim == 4 else F.conv3d
    if sp is not None and sp.is_sharded(x):
        y = conv(sp.halo(x, 1).movedim(-1, 1), kernel.to(x.dtype), padding=(0,) + (1,) * (x.ndim - 3))
    else:
        y = conv(x.movedim(-1, 1), kernel.to(x.dtype), padding=1)
    y = y.movedim(1, -1)
    yf = y.to(torch.promote_types(y.dtype, torch.float32)) + _ZeroGrad.apply(bias)
    if ema is None and group is not None:
        mean, var, n = group_moments(yf, group, sp)
        stats = (mean, var * (n / max(n - 1, 1)))
    elif ema is None:
        axes = tuple(range(yf.ndim - 1))
        mean = yf.mean(axes)
        var = torch.clamp_min(yf.square().mean(axes) - mean.square(), 0.0)
        n = yf.numel() // yf.shape[-1]
        stats = (mean, var * (n / max(n - 1, 1)))
    else:
        (mean, var), stats = ema, ema
    out = (yf - mean) * torch.rsqrt(var + BN_EPS) * scale + shift
    return torch.relu(out).to(x.dtype), stats


def coupling_chain(x: torch.Tensor, blocks: Sequence[Tuple[FG, FG]],
                   ema: Optional[Sequence[Tuple[Stats, Stats]]] = None,
                   group=None, sp=None) -> Tuple[torch.Tensor, List[Tuple[Stats, Stats]]]:
    """The coupling blocks in order, differentiable by autograd (which then
    stores every activation): (y, each block's (f, g) statistics). ``ema``
    gives each block's running statistics for eval mode; ``group`` the
    process group of train-mode statistics; ``sp`` the ``Space`` of a
    sharded x."""
    c = x.shape[-1] // 2
    x1, x2 = x[..., :c], x[..., c:]
    stats = []
    for i, (pf, pg) in enumerate(blocks):
        f_out, f_stats = _fg(x2, *pf, ema=ema[i][0] if ema else None, group=group, sp=sp)
        y1 = x1 + f_out
        g_out, g_stats = _fg(y1, *pg, ema=ema[i][1] if ema else None, group=group, sp=sp)
        x1, x2 = y1, x2 + g_out
        stats.append((f_stats, g_stats))
    return torch.cat([x1, x2], dim=-1), stats


def _vjp(x: torch.Tensor, p: FG, cotangent: torch.Tensor, group=None,
         sp=None) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """A coupling function at (x, p), run again in train mode: (its output,
    the cotangent's vector-Jacobian product for x and each of p)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        p = [t.detach().requires_grad_() for t in p]
        out, _ = _fg(x, *p, group=group, sp=sp)
        grads = torch.autograd.grad(out, (x, *p), cotangent)
    return out.detach(), grads


def _blocks(params: Sequence[torch.Tensor]) -> List[Tuple[FG, FG]]:
    """Flat (f kernel, bias, scale, shift, g kernel, ...) a block -> [(f, g)]."""
    return [(tuple(params[i:i + 4]), tuple(params[i + 4:i + 8])) for i in range(0, len(params), 8)]


class ReversibleChain(torch.autograd.Function):
    """Train-mode coupling blocks that keep only their output for the backward:
    ``apply(x, group, *params)`` (``group`` the process group of the batch
    statistics, or None), params per block (f kernel, bias, scale, shift, g
    kernel, bias, scale, shift), returns (y, then each block's f mean, f
    variance, g mean, g variance, which have no gradient).

    The forward runs the blocks with no autograd graph and saves the
    concatenated output it returns (the tensor the next op saves too) and the
    parameters. The backward walks the blocks in reverse: it reconstructs
    x2 = y2 - g(y1) and x1 = y1 - f(x2), running f and g again with
    autograd for their vector-Jacobian products, one function at a time.
    The twin of ``_rev_chain_train`` and its custom VJP."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, *params: torch.Tensor):
        sp = space_lib.current()  # the backward's thread may not see the context: ctx holds it
        y, stats = coupling_chain(x, _blocks(params), group=group, sp=sp)
        ctx.group, ctx.sp = group, sp
        flat = [t for block in stats for pair in block for t in pair]
        ctx.mark_non_differentiable(*flat)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, *params)
        return (y, *flat)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_y: Optional[torch.Tensor], *_):
        y, *params = ctx.saved_tensors
        c = y.shape[-1] // 2
        if grad_y is None:
            grad_y = torch.zeros_like(y)
        y1, y2 = y[..., :c], y[..., c:]
        g1, g2 = grad_y[..., :c], grad_y[..., c:]
        grads: List[torch.Tensor] = []
        for pf, pg in reversed(_blocks(params)):
            g_out, (dy1, *dpg) = _vjp(y1, pg, g2, ctx.group, ctx.sp)
            x2 = y2 - g_out
            g1 = g1 + dy1
            f_out, (dx2, *dpf) = _vjp(x2, pf, g1, ctx.group, ctx.sp)
            y1, y2 = y1 - f_out, x2
            g2 = g2 + dx2
            grads[:0] = [*dpf, *dpg]
        grad_x = torch.cat([g1, g2], dim=-1) if ctx.needs_input_grad[0] else None
        return (grad_x, None, *grads)


class ReversibleSequence(nn.Module):
    """The reference's ``ReversibleSequence``: where ``in_channels`` is not
    ``features``, a 1x1 ``ConvBNAct`` (``initial_conv``, run under
    ``remat``: its stored activations would otherwise erase the saving),
    then ``depth`` coupling blocks over a C/2 + C/2 split.

    Parameters per block i: ``block{i}_{f,g}_{kernel,bias,scale,shift}``
    (kernels OIHW (C/2, C/2, 3, 3), or OIDHW for ``ndim`` 3, float32); running statistics
    ``block{i}_{f,g}_{mean,var}``: the JAX module's leaf names. ``dtype`` is
    the compute dtype of ``initial_conv``; the blocks compute in their
    input's dtype, as in the JAX package.

    In train mode with autograd recording, the blocks run through
    ``ReversibleChain``; without it, as the plain chain. Either way the
    batch statistics are folded into the running ones once a call. In eval
    mode the plain chain runs on the running statistics.
    """

    def __init__(self, in_channels: int, features: int, depth: int = 3, init_scheme: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, device=None, generator: Optional[torch.Generator] = None,
                 ndim: int = 2):
        super().__init__()
        if features % 2:
            raise ValueError(f"a reversible sequence splits its channels in two: features must be even, got {features}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.initial_conv = (ConvBNAct(in_channels, features, kernel_size=1, init_scheme=init_scheme, dtype=dtype,
                                       device=device, generator=generator, ndim=ndim)
                             if in_channels != features else None)
        c = features // 2
        kernel_init, bias_init = init_lib.SCHEMES[init_scheme]
        if bias_init is None:
            bias_init = init_lib.torch_default_conv_bias(3 ** ndim * c)
        for i in range(depth):
            for fg in "fg":
                name = f"block{i}_{fg}"
                for leaf, value in (("kernel", kernel_init((c, c) + (3,) * ndim, generator)),
                                    ("bias", bias_init((c,), generator)),
                                    ("scale", torch.ones(c)), ("shift", torch.zeros(c))):
                    self.register_parameter(f"{name}_{leaf}", nn.Parameter(value.to(device)))
                self.register_buffer(f"{name}_mean", torch.zeros(c, device=device))
                self.register_buffer(f"{name}_var", torch.ones(c, device=device))
        self.process_group = None  # set for cross-rank statistics in train mode

    def blocks(self) -> List[Tuple[FG, FG]]:
        """Each block's (f, g) parameters: (kernel, bias, scale, shift) each."""
        return [tuple(tuple(getattr(self, f"block{i}_{fg}_{leaf}") for leaf in ("kernel", "bias", "scale", "shift"))
                      for fg in "fg") for i in range(self.depth)]

    def running_stats(self) -> List[Tuple[Stats, Stats]]:
        return [tuple((getattr(self, f"block{i}_{fg}_mean"), getattr(self, f"block{i}_{fg}_var")) for fg in "fg")
                for i in range(self.depth)]

    def forward(self, x: Tensors) -> torch.Tensor:
        x = _concat(x)
        if self.initial_conv is not None:
            x = remat(self.initial_conv, x)
        blocks = self.blocks()
        if not self.training:
            return coupling_chain(x, blocks, self.running_stats())[0]
        params = [t for block in blocks for p in block for t in p]
        sp = space_lib.current()
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
            y, *flat = ReversibleChain.apply(x, self.process_group, *params)
        else:
            with torch.no_grad():
                y, stats = coupling_chain(x, blocks, group=self.process_group, sp=sp)
            flat = [t for block in stats for pair in block for t in pair]
        running = [t for block in self.running_stats() for pair in block for t in pair]
        with torch.no_grad():
            torch._foreach_mul_(running, 1 - MOMENTUM)
            torch._foreach_add_(running, flat, alpha=MOMENTUM)
        return y
