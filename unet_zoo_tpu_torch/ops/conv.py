"""Convolution blocks, the twins of ``unet_zoo_tpu.ops.conv`` (2D NHWC and 3D NDHWC).

* ``Conv``      — bare conv with bias, the torch padding rule (k=3 -> 1,
                  else 0) and a selectable init scheme; a tuple input is an
                  implicit channel concat.
* ``ConvBNAct`` — conv, then BatchNorm (eps 1e-3, momentum 0.01) if
                  ``norm``, then ReLU if ``act``: the reference's ``Conv2D``
                  unit. ``norm=False, act=False`` is the bare 1x1 head.
* ``ConvSeq``   — ``depth`` stacked 3x3 ``ConvBNAct``. Without norm (the
                  U-Net block) it runs as the fused conv-chain kernel; with
                  norm (every PHiSeg sequence) as library ops, as in the JAX
                  package, whose BN sequences never reach its Pallas kernel,
                  except where eval-mode BatchNorm folds into the float32
                  kernel (``ConvSeq.folds``). The kernel is 2D: a BN-free 3D
                  sequence raises.
* ``conv_sequence`` — a sequence in one of the memory modes: ``plain``
                  (``ConvSeq``), ``remat`` (the same ``ConvSeq`` under
                  ``remat``, the twin of ``nn.remat``) or ``reversible``
                  (``ops/reversible.py``).

Spatial sharding (``parallel/space.py``): while it is active, a 3x3 conv
of a sharded input takes a 1-row halo (a 1-plane halo on axis 1 in 3D) and
runs 'valid' in the height; a 1x1 conv needs none. A BN-free ``ConvSeq``
runs its chain one stage at a time: a halo exchange, the fused chain's
stage on the ``h + 2``-row tile (the kernel on CUDA, one launch), then a
crop of the two edge rows, whose outputs read the zero padding of the tile
and get no gradient. The zero halo at the global top and bottom is the
'same' padding there, so every kept row is the unsharded chain's.

``ndim`` (2 or 3) is the number of spatial axes: the JAX modules infer it
from their input, the port's need it to shape their weights. Parameters are
float32 and OIHW or OIDHW (the ``nn.Conv2d``/``nn.Conv3d`` layouts) and are
drawn on the CPU from an explicit ``torch.Generator`` (so a seed gives the
same weights on every device), then moved to ``device``. ``dtype`` is the
compute dtype, as in the JAX package: operands are cast to it, the bias is
added in f32 and the result is cast back to it (``conv_chain.conv2d_nhwc``,
``conv3d_ndhwc``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unet_zoo_tpu_torch.ops import init as init_lib
from unet_zoo_tpu_torch.ops.norm import BatchNorm, recomputing
from unet_zoo_tpu_torch.ops.pallas.conv_chain import (conv2d_nhwc, fold_bn_pack, fused_conv_chain, pack_kernel,
                                                      packed_shape)
from unet_zoo_tpu_torch.parallel import space as space_lib
from unet_zoo_tpu_torch.utils import profiling

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]

MEMORY_MODES = ("plain", "remat", "reversible")

F32_ROUTE = "conv3x3_f32_3xtf32_wgmma"


def conv_span(x: torch.Tensor, weight: torch.Tensor) -> str:
    """A library convolution's span: ``conv.<in>-<out>.k<k>.<spatial>``, the
    input and output channels, the kernel size and the input's spatial
    shape (``HxW`` or ``DxHxW``)."""
    return "conv.%d-%d.k%d.%s" % (x.shape[-1], weight.shape[0], weight.shape[2], "x".join(map(str, x.shape[1:-1])))


def folded_span(x: torch.Tensor, convs: Sequence["Conv"]) -> str:
    """A folded BatchNorm sequence's span: ``conv.folded.<in>-<out>.d<depth>.<HxW>``."""
    return "conv.folded.%d-%d.d%d.%s" % (x.shape[-1], convs[-1].weight.shape[0], len(convs),
                                         "x".join(map(str, x.shape[1:-1])))


def chain_route(dtype: torch.dtype, device) -> str:
    """What ``ConvSeq(norm=False)`` runs a chain of ``dtype`` on ``device``
    with: the hand-written kernel on CUDA, "conv3x3_bf16_wgmma" for bf16 or
    "conv3x3_f32_3xtf32_wgmma" for float32 (3xTF32 on the tensor cores,
    f32-level error; ``tools/torch_f32_route.py`` times it against cuDNN),
    or "plain", the chain's plain version, on the CPU."""
    if torch.device(device).type != "cuda":
        return "plain"
    return F32_ROUTE if dtype == torch.float32 else "conv3x3_bf16_wgmma"


def conv3d_ndhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, padding: int) -> torch.Tensor:
    """The 3D twin of ``conv_chain.conv2d_nhwc``: ``F.conv3d`` in ``x.dtype``
    on the NDHWC input's ``channels_last_3d`` view, the bias added in f32,
    the result cast back to ``x.dtype``. OIDHW weight."""
    y = F.conv3d(x.movedim(-1, 1), weight.to(x.dtype), padding=padding).movedim(1, -1)
    return (y.float() + bias.float()).to(x.dtype)


def _recompute_contexts(sp):
    @contextlib.contextmanager
    def rerun():
        with recomputing(), space_lib.activate(sp):
            yield

    return contextlib.nullcontext(), rerun()


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``, the twin of JAX's
    ``nn.remat``: autograd keeps the inputs and the backward runs ``fn``
    again in place of storing what is inside it. A train-mode BatchNorm in
    that re-run leaves its running statistics alone (``norm.recomputing``),
    so they move once a step. The re-run enters the forward's spatial
    sharding (``parallel/space.py``), on whatever thread autograd runs it,
    so it repeats the forward's exchanges in the same order on every
    process. Nothing inside draws random numbers, so the RNG state is not
    saved. Without grad mode this is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=functools.partial(_recompute_contexts, space_lib.current()))


def _concat(x: Tensors) -> torch.Tensor:
    return torch.cat(list(x), dim=-1) if isinstance(x, (tuple, list)) else x


class _ZeroGrad(torch.autograd.Function):
    """Identity whose gradient is an exact zero. The JAX package stops the
    gradient of a bias that a train-mode BatchNorm follows (it is ~0 through
    BN anyway) and its optimizer then adds the coupled weight decay to that
    zero. A ``.detach()`` here would leave ``.grad`` as None, and
    ``torch.optim.Adam`` skips such a parameter: the decay-only update would
    be lost, about lr a step for every such bias."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(grad)


class Conv(nn.Module):
    """Bare convolution with bias over NHWC (``ndim`` 2) or NDHWC (3) input,
    torch padding rule and init.

    ``init_scheme`` is 'he_normal', 'orthogonal' or 'torch_default'. ``x``
    may be a tuple of tensors, concatenated along channels in order (the
    JAX package splits the kernel instead; the result is the same).
    ``grad_free_bias`` gives the bias an exact zero gradient (``_ZeroGrad``),
    for a conv that BatchNorm follows. Each call is the span
    ``uz.conv.<in>-<out>.k<k>.<spatial>`` (``conv_span``) in a profile: the
    library convolution, its halo exchange and its bias.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 init_scheme: str = "torch_default", grad_free_bias: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None, ndim: int = 2):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.padding = kernel_size // 2 if kernel_size == 3 else 0
        self.grad_free_bias = grad_free_bias
        self.dtype = dtype
        self.conv_nd = conv2d_nhwc if ndim == 2 else conv3d_ndhwc
        shape = (features, in_channels) + (kernel_size,) * ndim
        kernel_init, bias_init = init_lib.SCHEMES[init_scheme]
        if bias_init is None:
            bias_init = init_lib.torch_default_conv_bias(math.prod(shape[1:]))
        self.weight = nn.Parameter(kernel_init(shape, generator).to(device))
        self.bias = nn.Parameter(bias_init((features,), generator).to(device))

    def forward(self, x: Tensors) -> torch.Tensor:
        x = _concat(x)
        with profiling.span(conv_span, x, self.weight):
            x = x.to(self.dtype or x.dtype)
            bias = _ZeroGrad.apply(self.bias) if self.grad_free_bias else self.bias
            sp = space_lib.current()
            if self.padding and sp is not None and sp.is_sharded(x):
                return self.conv_nd(sp.halo(x, self.padding), self.weight, bias,
                                    (0,) + (self.padding,) * (x.ndim - 3))
            return self.conv_nd(x, self.weight, bias, self.padding)


class ConvBNAct(nn.Module):
    """conv -> BatchNorm (if ``norm``) -> ReLU (if ``act``), parameters at
    the JAX module's paths (``conv``, ``bn``). With ``norm`` the conv's bias
    gets an exact zero gradient, as in the JAX package. BatchNorm follows
    ``self.training``: batch statistics in train mode, the running ones in
    eval mode."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, norm: bool = True,
                 act: bool = True, init_scheme: str = "torch_default",
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None, ndim: int = 2):
        super().__init__()
        self.act = act
        self.conv = Conv(in_channels, features, kernel_size, init_scheme=init_scheme,
                         grad_free_bias=norm, dtype=dtype, device=device, generator=generator, ndim=ndim)
        self.bn = BatchNorm(features, device=device) if norm else None

    def forward(self, x: Tensors) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return torch.relu(y) if self.act else y


class ConvSeq(nn.Module):
    """``depth`` stacked 3x3 conv (+ BatchNorm if ``norm``) + ReLU, with
    ``conv{i}`` parameter paths as in the JAX package.

    With ``norm`` the layers run one by one as library ops, unless the
    sequence folds (``folds``: eval-mode BatchNorm, autograd not recording,
    the float32 kernel's route, 2D, not spatially sharded). Then each
    BatchNorm is folded into its conv (``conv_chain.fold_bn_pack``, one
    launch) and the sequence runs as one fused conv chain on the float32
    kernel, a launch a stage, under the span
    ``uz.conv.folded.<in>-<out>.d<depth>.<HxW>`` (``folded_span``).
    Without norm the sequence runs as one fused conv chain: the kernel of
    ``ops/pallas/conv_chain.py`` on CUDA, its plain version on the CPU
    (``chain_route``). Gradients reach the float32 ``weight``/``bias``
    parameters on both (``FusedConvChain`` on CUDA). The kernel is 2D: a
    BN-free 3D sequence raises ``NotImplementedError`` on every device.

    The CUDA chain packs the kernels into the kernel's weight layout in
    buffers allocated once per (dtype, device) and refilled on every
    forward, one copy per stage (a folded sequence: with the folded
    kernels, beside a buffer of the folded biases). A cache keyed on the
    parameters' ``_version`` would go stale: ``torch.optim.Adam(fused=True)``
    updates them in place without bumping it, and the running statistics
    move between evaluations.

    With ``remat`` the sequence runs under ``remat`` (after a tuple input is
    concatenated), with the same parameters: the backward runs it again, so
    a BN-free chain on CUDA launches its kernel twice a step."""

    def __init__(self, in_channels: int, features: int, depth: int, norm: bool = False,
                 init_scheme: str = "he_normal", remat: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None, ndim: int = 2):
        super().__init__()
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.norm = norm
        self.remat = remat
        self.dtype = dtype
        for i in range(depth):
            self.add_module(f"conv{i}", ConvBNAct(
                in_channels if i == 0 else features, features, norm=norm, init_scheme=init_scheme,
                dtype=dtype, device=device, generator=generator, ndim=ndim,
            ))
        self._packed: Dict[tuple, List[torch.Tensor]] = {}
        self._fold_biases: Dict[tuple, List[torch.Tensor]] = {}

    def _packed_kernels(self, weights: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
        key = (dtype, weights[0].device)
        self._packed[key] = [pack_kernel(w, dtype, out) for w, out in
                             zip(weights, self._packed.get(key, [None] * len(weights)))]
        return self._packed[key]

    def forward(self, x: Tensors) -> torch.Tensor:
        x = _concat(x)
        return remat(self._run, x) if self.remat else self._run(x)

    def folds(self, x: torch.Tensor) -> bool:
        """Whether this sequence runs on input ``x`` with its BatchNorms
        folded into the float32 conv-chain kernel: every BatchNorm in eval
        mode, autograd not recording (the kernel's gradients would be the
        folded kernels'), the compute dtype float32 on CUDA (``chain_route``),
        2D input, and that input not spatially sharded."""
        if not self.norm or x.ndim != 4 or any(layer.bn.training for layer in self.children()):
            return False
        if chain_route(self.dtype or x.dtype, x.device) != F32_ROUTE:
            return False
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in self.parameters())):
            return False
        sp = space_lib.current()
        return sp is None or not sp.is_sharded(x)

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """The sequence with its eval-mode BatchNorms folded: one
        ``fold_bn_pack`` launch into this module's buffers, then the chain,
        which on CUDA without autograd runs the packed (folded) kernels and
        the folded biases; the OIHW weights give it the shapes."""
        x = x.to(torch.float32).contiguous()
        convs, bns = [m.conv for m in self.children()], [m.bn for m in self.children()]
        with profiling.span(folded_span, x, convs):
            key = (torch.float32, x.device)
            if key not in self._fold_biases:
                cos = [c.weight.shape[0] for c in convs]
                # normal tensors even under inference_mode, as in pack_kernel
                with torch.inference_mode(False):
                    self._packed[key] = [torch.zeros(packed_shape(*c.weight.shape[:2], torch.float32), device=x.device)
                                         for c in convs]
                    self._fold_biases[key] = list(torch.empty(sum(cos), device=x.device).split(cos))
            packed, biases = self._packed[key], self._fold_biases[key]
            fold_bn_pack([(c.weight, c.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
                          for c, bn in zip(convs, bns)], packed, biases)
            return fused_conv_chain(x, [c.weight for c in convs], biases, packed=packed, round_taps=True)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm:
            if self.folds(x):
                return self._folded(x)
            for layer in self.children():
                x = layer(x)
            return x
        if x.ndim == 5:
            raise NotImplementedError("the conv-chain kernel is 2D: a BN-free 3D conv sequence has no kernel")
        x = x.to(self.dtype or x.dtype).contiguous()
        convs = [m.conv for m in self.children()]
        weights = [c.weight for c in convs]
        packed = self._packed_kernels(weights, x.dtype) if x.is_cuda else None
        sp = space_lib.current()
        if sp is None or not sp.is_sharded(x):
            return fused_conv_chain(x, weights, [c.bias for c in convs], packed=packed)
        for j, c in enumerate(convs):
            tile = sp.halo(x, 1)
            x = fused_conv_chain(tile, [c.weight], [c.bias], packed=None if packed is None else [packed[j]])[:, 1:-1]
        return x


def conv_sequence(in_channels: int, features: int, depth: int, mode: str = "plain", rev_depth: Optional[int] = None,
                  norm: bool = True, init_scheme: str = "torch_default", dtype: Optional[torch.dtype] = None,
                  device=None, generator: Optional[torch.Generator] = None, ndim: int = 2) -> nn.Module:
    """A conv sequence in memory mode ``mode``, the twin of the JAX
    package's ``conv_sequence``:

    * "plain": ``ConvSeq``, every activation stored for the backward;
    * "remat": the same ``ConvSeq`` under ``remat``, the same parameters
      (``conv{i}``), so checkpoints interchange with "plain";
    * "reversible": ``ReversibleSequence`` of ``rev_depth`` (default
      ``depth``) coupling blocks, another parameter tree; it always carries
      BatchNorm, whatever ``norm`` says, as in the JAX package.
    """
    if mode == "reversible":
        from unet_zoo_tpu_torch.ops.reversible import ReversibleSequence

        return ReversibleSequence(in_channels, features, rev_depth if rev_depth is not None else depth,
                                  init_scheme=init_scheme, dtype=dtype, device=device, generator=generator,
                                  ndim=ndim)
    if mode not in MEMORY_MODES:
        raise ValueError(f"memory mode must be one of {MEMORY_MODES}, got '{mode}'")
    return ConvSeq(in_channels, features, depth, norm=norm, init_scheme=init_scheme, remat=mode == "remat",
                   dtype=dtype, device=device, generator=generator, ndim=ndim)
