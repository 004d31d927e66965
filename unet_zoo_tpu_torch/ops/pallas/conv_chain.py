"""Fused chain of 3x3 'same' convolutions, each followed by bias and ReLU.

The twin of ``unet_zoo_tpu.ops.pallas.conv_chain.fused_conv_chain``: for N
NHWC stages it computes ``relu(conv3x3(... relu(conv3x3(x, K0) + b0) ...) +
b_{N-1})`` with zero padding, f32 accumulation, the bias added in f32, and
each stage's result stored in ``x.dtype``. Weights are cast to ``x.dtype``.

On CUDA tensors every stage is one launch of the hand-written kernel in
``csrc/conv_chain.cu`` (see the note at its top for the design), with the
launch's plan (tile, output channels a block, pipeline stages, shared
memory, grid, halo loader) from ``launch_plan`` (bf16) or
``f32_launch_plan`` (float32) here. The float32 kernel computes in 3xTF32
on the tensor cores (each operand split into tf32 hi and lo halves,
``split_tf32``; the weights once, by ``pack_kernel``), to f32-level error;
``fused_conv_chain_3xtf32`` is the same arithmetic in plain PyTorch. On CPU
tensors the wrapper runs ``fused_conv_chain_reference``, the plain PyTorch
version, which is also the kernel's oracle on the card. In the port this
chain *is* the BN-free U-Net block (``models/blocks.py``).

Gradients. When autograd records (grad mode on and an input requiring
grad), the CUDA path runs through ``FusedConvChain``: its forward is the same
kernel launches and keeps each stage's output, the ReLU mask and the next
stage's input; its backward masks the cotangent, sums the bias gradient in
f32 and takes dgrad and wgrad from the library's conv gradients
(``aten.convolution_backward``). The JAX package has no backward kernel
either: its Pallas kernel defines no autodiff rule, and its train step
differentiates the plain ``Conv`` with XLA's conv transposes
(``unet_zoo_tpu/ops/conv.py``). The cast points are those XLA takes there:
a cotangent in ``x.dtype`` into the conv, operands in ``x.dtype``, the
weight gradient cast to f32, the parameters' dtype. Under ``no_grad`` or
``inference_mode`` the wrapper launches the stages directly and saves
nothing.

Kernels are OIHW, the port's storage layout (``nn.Conv2d``'s), not the JAX
package's HWIO.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_zoo_tpu_torch.ops.pallas import _build

# Number of kernel launches (one per stage on CUDA tensors). Callers reset it
# by assignment; the CPU path never moves it.
launches = 0

# The bf16 kernel streams input channels in K chunks of 16, 32 or 64 (the
# narrowest that holds C_in, else 64 = ``_CI_ALIGN``), so ``pack_kernel``
# zero-pads C_in to a whole number of chunks (``padded_ci``); output channels
# are padded to 64. The f32 kernel takes chunks of 8, 16 or 32 channels
# (the same 32, 64 or 128-byte rows), so its C_in pads to those
# (``f32_padded_ci``).
_CHUNKS = (16, 32, 64)
F32_CHUNKS = (8, 16, 32)
# the f32 kernel's channel blocks: its two accumulators (a chunk's and the
# total) beside two taps' split A registers must fit the 168 registers a
# thread of a 288-thread block has, which leaves no room for 128 or 192 (C_out
# 128 takes two blocks of 64, 192 two of 96)
F32_BLOCK_NS = (32, 64, 96)
_CI_ALIGN = _CHUNKS[-1]
_CO_ALIGN = 64
_DTYPES = (torch.float32, torch.bfloat16)

# the card the plan is made for: an H100's SMs and the dynamic shared memory a block may have
SM_COUNT = 132
SMEM_LIMIT = 232448
TILE_W = 16
BLOCK_NS = (32, 64, 128, 192)  # wgmma widths; wider C_out takes 128-channel blocks along grid y
HALO_STAGES = 2  # up to 4 where the weights stay resident
_HALO_STAGES_MAX = 4
WEIGHT_STAGES = 4  # up to 8 where the block has its SM's shared memory to itself anyway
_WEIGHT_STAGES_MAX = 8
_RESIDENT_STAGES_MAX = 54  # 6 chunks x 9 taps: the mbarriers' 1024 bytes
_SMEM_FIXED = 2048  # 1024 bytes of alignment slack + 1024 for the mbarriers
TMA_BOX_MAX = 256


def chunk_width(ci: int) -> int:
    """Input channels a K chunk of the bf16 kernel for C_in = ``ci``."""
    return next((c for c in _CHUNKS if ci <= c), _CI_ALIGN)


def padded_ci(ci: int) -> int:
    return _round_up(ci, chunk_width(ci))


def f32_chunk_width(ci: int) -> int:
    """Input channels a K chunk of the f32 kernel for C_in = ``ci`` (at most;
    a plan may take a narrower one that divides the padded C_in)."""
    return next((c for c in F32_CHUNKS if ci <= c), F32_CHUNKS[-1])


def f32_padded_ci(ci: int) -> int:
    return _round_up(ci, f32_chunk_width(ci))


def packed_shape(co: int, ci: int, dtype: torch.dtype) -> tuple:
    """The shape ``pack_kernel`` gives a (co, ci, 3, 3) kernel in ``dtype``."""
    if dtype == torch.float32:
        return (2, _round_up(co, _CO_ALIGN), 3, 3, f32_padded_ci(ci))
    return (_round_up(co, _CO_ALIGN), 3, 3, padded_ci(ci))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One bf16 stage's launch, as ``conv3x3_bias_relu_bf16`` takes and checks it.

    A work item is ``tile_h`` x ``TILE_W`` output pixels (one consumer
    warpgroup per 4 rows) by ``block_n`` output channels; the grid is
    persistent (the launcher starts as many blocks as fit on the card at
    once, each walking ``items`` / blocks work items). K runs over (chunk,
    tap) with the input halo in a ring of ``halo_stages`` and the weight
    tiles in a ring of ``weight_stages``; with ``resident`` the weights'
    9 * chunks tiles all fit and stay in shared memory, loaded once a
    block. ``loader`` is "tma" (a 4-D tensor map over NHWC) or "plain"
    (masked loads by the producer warp, where TMA cannot take the input's
    strides or alignment)."""

    chunk: int
    ci_pad: int
    co_pad: int
    block_n: int
    tile_h: int
    halo_stages: int
    weight_stages: int
    smem_bytes: int
    items: int
    threads: int
    loader: str
    resident: bool

    @property
    def halo_box(self) -> tuple:
        """The TMA box over (C, W, H, B), innermost first."""
        return (self.chunk, TILE_W + 2, self.tile_h + 2, 1)

    @property
    def weight_box(self) -> tuple:
        """The TMA box over the packed weights (9 * C_in_pad, C_out_pad)."""
        return (self.chunk, self.block_n)


@functools.lru_cache(maxsize=None)
def launch_plan(shape: tuple, co: int, aligned: bool = True, tile_h: Optional[int] = None,
                halo_stages: Optional[int] = None, resident: Optional[bool] = None) -> LaunchPlan:
    """The plan of one bf16 stage on x of NHWC ``shape`` -> ``co`` channels;
    ``aligned`` says whether x's address is a multiple of 16 bytes.
    ``tile_h``, ``halo_stages`` and ``resident`` replace the plan's own
    choices (to time other plans); the rest follows from them."""
    batch, height, width, ci = shape
    chunk = chunk_width(ci)
    block_n = next((n for n in BLOCK_NS if co <= n), 128)
    tiles = batch * -(-width // TILE_W)
    n_blocks = -(-co // block_n)
    # 8-row tiles (two consumer warpgroups) unless they leave SMs idle
    if tile_h is None:
        tile_h = 8 if tiles * -(-height // 8) * n_blocks >= SM_COUNT else 4
    halo_stride = _round_up((tile_h + 2) * (TILE_W + 2) * chunk * 2, 1024)
    weight_bytes = block_n * chunk * 2
    ci_pad = _round_up(ci, chunk)
    all_weights = 9 * (ci_pad // chunk)
    # resident only where two blocks still fit on an SM: one block alone
    # cannot hide its own epilogue and waits (measured: 64 -> 64 channels
    # went from 0.41 to 0.50 ms at bs512 with the weights resident, on an
    # NVIDIA H100 80GB HBM3 at 700 W)
    half = SMEM_LIMIT // 2 - 1024
    if resident is None:
        resident = (n_blocks == 1 and all_weights <= _RESIDENT_STAGES_MAX
                    and _SMEM_FIXED + HALO_STAGES * halo_stride + all_weights * weight_bytes <= half)
    if resident:
        stages = all_weights
        if halo_stages is None:
            halo_stages = max((h for h in range(HALO_STAGES, _HALO_STAGES_MAX + 1)
                               if _SMEM_FIXED + h * halo_stride + stages * weight_bytes <= half),
                              default=HALO_STAGES)
    else:
        halo_stages, stages = halo_stages or HALO_STAGES, WEIGHT_STAGES
        fixed = _SMEM_FIXED + halo_stages * halo_stride
        if 2 * (fixed + stages * weight_bytes) > SMEM_LIMIT:  # one block an SM: fill its shared memory
            stages = min(_WEIGHT_STAGES_MAX, (SMEM_LIMIT - fixed) // weight_bytes)
    return LaunchPlan(
        chunk=chunk, ci_pad=ci_pad, co_pad=_round_up(co, _CO_ALIGN), block_n=block_n,
        tile_h=tile_h, halo_stages=halo_stages, weight_stages=stages,
        smem_bytes=_SMEM_FIXED + halo_stages * halo_stride + stages * weight_bytes,
        items=tiles * -(-height // tile_h) * n_blocks, threads=32 * tile_h + 32,
        # TMA takes global strides in multiples of 16 bytes: C_in % 8 == 0
        loader="tma" if ci % 8 == 0 and aligned else "plain",
        resident=resident,
    )


@dataclasses.dataclass(frozen=True)
class F32LaunchPlan:
    """One f32 stage's launch, as ``conv3x3_bias_relu_f32`` takes and checks it.

    A work item is a tile of ``n_img`` images x ``tile_h`` rows x ``tile_w``
    columns (``n_img`` > 1 folds whole images smaller than the tile into
    it), at most 64 pixels a consumer warpgroup, by ``block_n`` output
    channels. The rest reads as in ``LaunchPlan``; a weight stage holds the
    (chunk, tap) tile's tf32 hi and lo halves."""

    chunk: int
    ci_pad: int
    co_pad: int
    block_n: int
    tile_h: int
    tile_w: int
    n_img: int
    warpgroups: int
    halo_stages: int
    weight_stages: int
    smem_bytes: int
    items: int
    threads: int
    loader: str
    resident: bool

    @property
    def halo_box(self) -> tuple:
        """The TMA box over (C, W, H, B), innermost first."""
        return (self.chunk, self.tile_w + 2, self.tile_h + 2, self.n_img)

    @property
    def weight_box(self) -> tuple:
        """The TMA box over the packed weights (9 * C_in_pad, C_out_pad, 2): one half."""
        return (self.chunk, self.block_n, 1)


def _f32_tile(shape: tuple, warpgroups: int) -> tuple:
    """(tile_h, tile_w, n_img) of ``warpgroups`` x 64 pixels: 16-pixel rows,
    or whole rows of a narrower image, and whole images where one fits."""
    batch, height, width, _ = shape
    pixels = 64 * warpgroups
    tile_w = min(width, TILE_W)
    tile_h = min(height, pixels // tile_w)
    n_img = min(batch, pixels // (tile_h * tile_w)) if tile_h == height else 1
    return tile_h, tile_w, n_img


@functools.lru_cache(maxsize=None)
def f32_launch_plan(shape: tuple, co: int, aligned: bool = True, warpgroups: Optional[int] = None,
                    block_n: Optional[int] = None, resident: Optional[bool] = None) -> F32LaunchPlan:
    """The plan of one f32 stage on x of NHWC ``shape`` -> ``co`` channels;
    ``aligned`` says whether x's address is a multiple of 16 bytes.

    Tile and channel block: all of C_out (up to 96; 128 and 192 as two
    blocks) on two warpgroups' tiles, else on one warpgroup's, else ever
    narrower channel blocks, whichever first gives the card's SMs an item
    each, else the narrowest (the small images: ProbUNet's 2x2-8x8 levels). The K chunk is the
    widest that divides the padded C_in and leaves room for two weight
    stages. ``warpgroups``, ``block_n`` and ``resident`` replace the plan's
    own choices (to time other plans); the rest follows from them.

    Where the items are fewer than the card's SMs, each block has its SM
    to itself and walks one item: the weight ring then takes all the shared
    memory the halo leaves (up to the K loop's 9 * chunks stages), since a
    small image's item is a long K loop on little else, bound by how far
    the producer's weight loads run ahead."""
    batch, height, width, ci = shape
    ci_pad = f32_padded_ci(ci)
    full = min(F32_BLOCK_NS, key=lambda n: (-(-co // n) * n, -n))  # the least padding, then the widest
    narrower = [n for n in reversed(F32_BLOCK_NS) if n < full]

    def items_of(wg, n):
        tile_h, tile_w, n_img = _f32_tile(shape, wg)
        return -(-batch // n_img) * -(-height // tile_h) * -(-width // tile_w) * -(-co // n)

    if warpgroups is None or block_n is None:
        options = [(warpgroups or 2, block_n or full), (warpgroups or 1, block_n or full)]
        options += [(warpgroups or 1, n) for n in ([] if block_n else narrower)]
        warpgroups, block_n = next((o for o in options if items_of(*o) >= SM_COUNT), options[-1])
    tile_h, tile_w, n_img = _f32_tile(shape, warpgroups)
    n_blocks = -(-co // block_n)
    half = SMEM_LIMIT // 2 - 1024
    # at 96 channels a 32-channel chunk's two taps of split A registers do
    # not fit beside the accumulators (ptxas spills)
    widest = min(f32_chunk_width(ci), 16 if block_n == 96 else 32)
    for chunk in (c for c in reversed(F32_CHUNKS) if c <= widest and ci_pad % c == 0):
        halo_stride = _round_up(n_img * (tile_h + 2) * (tile_w + 2) * chunk * 4, 1024)
        stage_bytes = 2 * block_n * chunk * 4
        all_weights = 9 * ci_pad // chunk
        fits_resident = (n_blocks == 1 and all_weights <= _RESIDENT_STAGES_MAX
                         and _SMEM_FIXED + HALO_STAGES * halo_stride + all_weights * stage_bytes <= half)
        is_resident = fits_resident if resident is None else resident
        if is_resident:
            stages = all_weights
            halo_stages = max((h for h in range(HALO_STAGES, _HALO_STAGES_MAX + 1)
                               if _SMEM_FIXED + h * halo_stride + stages * stage_bytes <= half), default=HALO_STAGES)
        else:
            halo_stages, stages = HALO_STAGES, WEIGHT_STAGES
            fixed = _SMEM_FIXED + halo_stages * halo_stride
            if items_of(warpgroups, block_n) < SM_COUNT:  # a block an SM, one item each: a deep ring
                stages = min(_RESIDENT_STAGES_MAX, all_weights, (SMEM_LIMIT - fixed) // stage_bytes)
            elif 2 * (fixed + stages * stage_bytes) > SMEM_LIMIT:  # one block an SM: fill its shared memory
                stages = min(_WEIGHT_STAGES_MAX, (SMEM_LIMIT - fixed) // stage_bytes)
        smem = _SMEM_FIXED + halo_stages * halo_stride + stages * stage_bytes
        if stages >= 2 and smem <= SMEM_LIMIT:
            break
    return F32LaunchPlan(
        chunk=chunk, ci_pad=ci_pad, co_pad=_round_up(co, _CO_ALIGN), block_n=block_n, tile_h=tile_h,
        tile_w=tile_w, n_img=n_img, warpgroups=warpgroups, halo_stages=halo_stages, weight_stages=stages,
        smem_bytes=smem, items=items_of(warpgroups, block_n), threads=128 * warpgroups + 32,
        # TMA takes global strides in multiples of 16 bytes: C_in % 4 == 0 in f32
        loader="tma" if ci % 4 == 0 and aligned else "plain",
        resident=is_resident,
    )


def _check(x: torch.Tensor, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> None:
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty NHWC tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not kernels or len(kernels) != len(biases):
        raise ValueError(f"need one bias per kernel and at least one stage, got "
                         f"{len(kernels)} kernels and {len(biases)} biases")
    c = x.shape[-1]
    for j, (k, b) in enumerate(zip(kernels, biases)):
        if k.ndim != 4 or tuple(k.shape[1:]) != (c, 3, 3):
            raise ValueError(f"stage {j}: kernel must be OIHW (C_out, {c}, 3, 3), got {tuple(k.shape)}")
        if tuple(b.shape) != (k.shape[0],):
            raise ValueError(f"stage {j}: bias must be ({k.shape[0]},), got {tuple(b.shape)}")
        if k.device != x.device or b.device != x.device:
            raise ValueError(f"stage {j}: kernel and bias must be on {x.device}")
        c = k.shape[0]


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, padding: int) -> torch.Tensor:
    """One conv with the JAX package's cast points (``unet_zoo_tpu/ops/conv.py``):
    ``F.conv2d`` in ``x.dtype``, the bias added in f32, the result cast back
    to ``x.dtype``. NHWC in and out, OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=padding).permute(0, 2, 3, 1)
    return (y.float() + bias.float()).to(x.dtype)


def fused_conv_chain_reference(x, kernels, biases):
    """Plain PyTorch version: ``conv2d_nhwc`` then ReLU, per stage."""
    for k, b in zip(kernels, biases):
        x = torch.relu(conv2d_nhwc(x, k, b, padding=1))
    return x


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 stored mantissa bits, the low 13 bits zero) rounded to
    nearest, ties away from zero: ``cvt.rna.tf32.f32``, on the bits."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple:
    """(hi, lo) of a float32 tensor: hi = tf32(t), lo = tf32(t - hi), so that
    hi + lo is t within 2^-22 |t| and hi * lo' + lo * hi' + hi * hi' is the
    product of two such splits within ~2^-21 relative (3xTF32)."""
    hi = _round_tf32(t)
    return hi, _round_tf32(t - hi)


def fused_conv_chain_3xtf32(x, kernels, biases):
    """The f32 kernel's arithmetic in plain PyTorch (float32 convs, which on
    a card need cuDNN's TF32 off): per stage, with x and the kernel split by
    ``split_tf32``, conv(x_lo, k_hi) + conv(x_hi, k_lo) + conv(x_hi, k_hi),
    then the bias and ReLU. It differs from the kernel in the f32 sums
    alone: their order, and the tensor cores' own accumulation within a K
    chunk."""
    def conv(a, k):
        return F.conv2d(a.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)

    for k, b in zip(kernels, biases):
        (x_hi, x_lo), (k_hi, k_lo) = split_tf32(x.float()), split_tf32(k.float())
        x = torch.relu(conv(x_lo, k_hi) + conv(x_hi, k_lo) + conv(x_hi, k_hi) + b.float())
    return x


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    lib.conv3x3_bias_relu_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    lib.conv3x3_bias_relu_bf16.restype = ctypes.c_int
    lib.conv3x3_bias_relu_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
    lib.conv3x3_bias_relu_f32.restype = ctypes.c_int
    lib.conv_chain_error_string.argtypes = [ctypes.c_int]
    lib.conv_chain_error_string.restype = ctypes.c_char_p
    return lib


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_kernel(kernel: torch.Tensor, dtype: torch.dtype, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OIHW kernel -> the CUDA kernel's weight layout: (C_out rounded up to 64,
    3, 3, ``padded_ci(C_in)``) in ``dtype``, zero past C_out and C_in, so
    that for each output channel the 9 taps' input channels lie contiguous:
    viewed as (C_out_pad, 9 * C_in_pad), K-major, each (chunk, tap) is one
    TMA box of the bf16 kernel. In float32 the layout is there twice, (2,
    C_out_pad, 3, 3, ``f32_padded_ci(C_in)``): the kernel's tf32 hi and lo
    halves (``split_tf32``), which the f32 kernel's 3xTF32 products take.

    ``out``, an earlier result for a kernel of the same shape, is refilled
    in place (its zero padding stays) and returned. Not differentiable."""
    co, ci = kernel.shape[:2]
    if out is None:
        # a normal tensor even under inference_mode, so that a refill after
        # it (a train step after an evaluation) is allowed
        with torch.inference_mode(False):
            out = torch.zeros(packed_shape(co, ci, dtype), dtype=dtype, device=kernel.device)
    with torch.no_grad():
        if dtype == torch.float32:
            # split_tf32 in place, in few ops (a forward refills every stage):
            # w into the lo half, hi = tf32(w) beside it, then lo = tf32(w - hi)
            hi, lo = out[0], out[1]
            lo[:co, :, :, :ci] = kernel.permute(0, 2, 3, 1)
            torch.bitwise_and(lo.view(torch.int32) + 0x1000, -0x2000, out=hi.view(torch.int32))
            lo.sub_(hi).view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)
        else:
            out[:co, :, :, :ci] = kernel.permute(0, 2, 3, 1)
    return out


def _launch_stage(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor,
                  plan=None) -> torch.Tensor:
    """One stage on the card under ``plan``, by default the stage's
    ``launch_plan`` (bf16) or ``f32_launch_plan`` (float32)."""
    global launches
    lib = _lib()
    batch, height, width, ci = x.shape
    co = bias.shape[0]
    b = bias.to(torch.float32).contiguous()
    out = torch.empty((batch, height, width, co), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), packed.data_ptr(), b.data_ptr(), out.data_ptr(), batch, height, width, ci,
            packed.shape[-1], co, packed.shape[-4])
    aligned = x.data_ptr() % 16 == 0
    if x.dtype == torch.bfloat16:
        p = plan or launch_plan(tuple(x.shape), co, aligned)
        err = lib.conv3x3_bias_relu_bf16(
            *args, p.chunk, p.block_n, p.tile_h, p.halo_stages, p.weight_stages,
            p.smem_bytes, p.loader == "tma", p.resident, x.device.index, stream)
    else:
        p = plan or f32_launch_plan(tuple(x.shape), co, aligned)
        err = lib.conv3x3_bias_relu_f32(
            *args, p.chunk, p.block_n, p.tile_h, p.tile_w, p.n_img, 4 * p.warpgroups, p.halo_stages,
            p.weight_stages, p.smem_bytes, p.loader == "tma", p.resident, x.device.index, stream)
    if err:
        raise RuntimeError(
            f"conv3x3 kernel launch failed for x {tuple(x.shape)} -> {co} channels: "
            f"{lib.conv_chain_error_string(err).decode()}"
        )
    launches += 1
    return out


class FusedConvChain(torch.autograd.Function):
    """The kernel chain with a backward: ``apply(x, packed, k0, b0, k1, b1, ...)``.

    ``packed[j]`` is ``pack_kernel(k_j, x.dtype)``, an input with no gradient;
    the OIHW float32 kernels and biases are the differentiable parameters.
    The forward launches the kernel once per stage and saves x and every
    stage's output; the backward runs the library's conv gradients (see the
    module docstring). No kernel runs in the backward, so it counts no launch.
    """

    @staticmethod
    def forward(ctx, x, packed, *params):
        ys = [x]
        for w, b in zip(packed, params[1::2]):
            ys.append(_launch_stage(ys[-1], w, b))
        ctx.save_for_backward(*params[0::2], *ys)
        return ys[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        kernels, ys = saved[:n], saved[n:]  # ys[j] is stage j's input, ys[j + 1] its output
        grads = [None] * (2 * n)
        g = grad
        for j in reversed(range(n)):
            g = torch.where(ys[j + 1] > 0, g, 0)
            if ctx.needs_input_grad[3 + 2 * j]:
                grads[2 * j + 1] = g.float().sum((0, 1, 2))
            need_x = j > 0 or ctx.needs_input_grad[0]
            # NHWC permuted to NCHW is a channels_last view, which cuDNN takes as is
            gx, gk, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), ys[j].permute(0, 3, 1, 2), kernels[j].to(g.dtype), None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [need_x, ctx.needs_input_grad[2 + 2 * j], False],
            )
            if gk is not None:
                grads[2 * j] = gk.float()
            g = gx.permute(0, 2, 3, 1) if need_x else None
        return (g, None, *grads)


def fused_conv_chain(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], relu_last: bool = True,
                     packed: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """x: (B, H, W, C0) NHWC, float32 or bfloat16. kernels[j]: (C_{j+1}, C_j, 3, 3)
    OIHW; biases[j]: (C_{j+1},). Returns (B, H, W, C_N) in ``x.dtype``.

    CPU tensors take the plain version (differentiable by autograd); CUDA
    tensors launch the kernel once per stage, or raise, through
    ``FusedConvChain`` when autograd records. ``packed`` optionally gives
    ``pack_kernel(k, x.dtype)`` of each kernel, for a caller that keeps the
    buffers across calls; without it the kernels are packed on every call.
    The CPU path ignores it.
    """
    if not relu_last:
        raise NotImplementedError("non-ReLU last stage not implemented (nor in the JAX kernel)")
    _check(x, kernels, biases)
    if x.device.type == "cpu":
        return fused_conv_chain_reference(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain runs on CPU or CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if packed is None:
        packed = [pack_kernel(k, x.dtype) for k in kernels]
    if len(packed) != len(kernels):
        raise ValueError(f"need one packed kernel per stage, got {len(packed)} for {len(kernels)} stages")
    for j, (k, w) in enumerate(zip(kernels, packed)):
        want = packed_shape(k.shape[0], k.shape[1], x.dtype)
        if tuple(w.shape) != want or w.dtype != x.dtype or w.device != x.device or not w.is_contiguous():
            raise ValueError(f"stage {j}: packed kernel must be contiguous {want} {x.dtype} on "
                             f"{x.device}, got {tuple(w.shape)} {w.dtype} on {w.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *kernels, *biases)):
        return FusedConvChain.apply(x, packed, *(t for kb in zip(kernels, biases) for t in kb))
    for w, b in zip(packed, biases):
        x = _launch_stage(x, w, b)
    return x
