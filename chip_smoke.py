#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``unet_zoo_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one NVIDIA GPU and nvcc

Phases, each printing its own lines:

1. environment: torch and CUDA versions, the card's name and power limit,
   the kernel build time, ptxas's registers, spills and static shared
   memory per kernel, and a check of the bf16 kernel's machine code
   (``cuobjdump -sass``): every instantiation issues wgmma (``HGMMA``) and
   TMA loads (``UTMALDG``) and no ``mma.sync`` (``HMMA``);
2. every hand-written kernel against its plain PyTorch version on the card,
   at the kernel tests' shapes, edge shapes (one full and one partial K
   chunk, 192 output channels in one block, C_in = 1 on the plain loader,
   images that are no multiple of the tile, batch 1) and each U-Net block
   shape (batch 8), in float32 and bfloat16, with each bf16 stage's launch
   plan;
3. the slice: the full-width U-Net forward (filters 32/64/128/192, 2 classes,
   batch 512, 128x128x1, bf16) under inference mode, with the kernel launch
   count checked; those logits against the same model with every block on
   the chain's plain version, on the card; a batch-2 float32 forward on the
   card (21 launches of the float32 kernel, ``conv3x3_f32_fma``) against the
   same weights on the CPU (plain path); and the main
   path's bf16 logits of two images against that f32 CPU model;
4. each block at batch 512 and at batch 64 on the model's weights: the
   kernel against its plain version, REPEATS more launches each bit for bit
   against the first (a race between the pipeline's producer and its
   consumers shows as launches that disagree), then times with CUDA events: the
   forward's images/s, the host's time to issue one kernel launch, and
   each block's kernel time beside its plain version's, cuDNN's
   conv+bias+ReLU (the yardstick, never called by the port) and its bound
   (the larger of its FLOPs at the bf16 peak and its input and output bytes
   at the memory rate);
5. the train slice: the chain's autograd Function (kernel forward, library
   conv gradients) against autograd of the plain version at the test and
   edge shapes in float32; the full-width train step (bf16, batch 64,
   128x128x1, the ``unet`` experiment's device augmentation, coupled-L2 Adam,
   plateau LR) for TRAIN_STEPS steps from a fixed seed, with 21 launches a
   step, no host sync inside a step, a finite loss, a non-zero gradient in
   every conv weight and bias, and a falling loss; PARITY_STEPS steps of
   the kernel path, each against the same step from the same state and
   augmentation draws on a plain path differentiated by autograd: step 1
   (loss and every gradient) on the chain's plain version, steps 2 and on
   (loss) on the kernel's own function in plain PyTorch, computed from the
   f32 parameters; then train-step images/s on the kernel path and the
   plain path (every block on the plain version), the host's time to issue
   one step on each, and the milliseconds of each phase of a step;
6. PHiSeg 2D (``phiseg_7_5_12``: filters 32/64/128/192/192/192/192, 5 latent
   levels, 2 classes, 128x128), which launches no hand-written kernel (its
   conv sequences carry BatchNorm and run as library ops, as in the JAX
   package): (a) a batch-2 float32 forward with the mask, the loss and every
   gradient on the card against the same weights and z noise on the CPU (TF32
   off), in train mode and in eval mode, and the running statistics; (b) the
   bf16 train step at batch 12 with the experiment's device augmentation for
   PHISEG_STEPS steps from a fixed seed: no host sync inside a step, a
   gradient in every parameter (an exact zero in each conv bias that
   BatchNorm follows, which Adam's weight decay still moves), running
   statistics that change, a falling loss and no conv-chain launch; (c) the
   step's images/s (CUDA events), the host's time to issue one step, the ms
   of each phase, and ``sample(x, 100)`` at batch 1 in ms an image;
7. evaluation and the harness: (a) GED, variance-NCC and Dice on the card
   against the CPU on the same inputs at the evaluation's shape (100
   samples, 4 annotators, 128x128; 2 classes and 3, empty masks among
   them): intersections exact, Dice equal, GED within GED_RTOL of
   max(1, |ref|), NCC within NCC_ATOL; (b) the 100-sample evaluation of one
   image by the bf16 ``phiseg_7_5_12`` (``Trainer.eval_image``, the twin of
   the JAX ``bench.py`` eval row): ms an image (the min of fenced calls)
   and the host's time to issue one, finite GED, NCC in [-1, 1] and Dice in
   [0, 1]; (c) the float32 ``phiseg_7_5_12`` evaluation of one image with 16
   samples on the card against the CPU on the same weights and noise: the
   logits, the metrics of the CPU's logits on both sides, and the eval-mode
   loss; (d) the harness on in-memory synthetic LIDC (128x128, 4 graders)
   for the bf16 ``unet`` and ``phiseg_7_5_12``: ``train`` for 20 iterations
   with a validation every 10 (the U-Net's conv-chain launches counted),
   the checkpoint and metrics files, a validation that leaves the train
   state bit-identical and issues no host sync while it enqueues the
   images, validation seconds an image (the evaluation alone, and the
   whole ``validate`` with its checkpoint writes), for the U-Net the
   validation path's batch-1 forwards and ``evaluate_images`` rows with
   the kernel against the chain's plain version on the same trained
   weights, images and picks (logits within BF16_FORWARD_ULPS, no argmax
   flip, GED and Dice equal, NCC within what the logits' difference can
   move it plus NCC_ATOL, loss terms within twice the logits' max|diff|),
   and two test sweeps that write the same ``test_results.npz``;
8. the remat and reversible memory modes: (a) ``ReversibleChain`` against
   autograd of the same coupling chain at the full-width block shapes
   (REV_BLOCK_SHAPES), each gradient's distance from the float64 one
   against autograd's, in float32 with TF32 off (REV_F32_VS_AUTOGRAD) and
   bf16 (from the f32 one, REV_BF16_VS_AUTOGRAD); (b) a batch-2 float32
   ``phiseg_rev_7_5_12`` forward, loss, gradients and running statistics in
   train mode on the card against the CPU, at phase 6's train-mode gates;
   (c) MODE_STEPS bf16 steps each of ``phiseg_rev_7_5_12`` at batch 12,
   ``reversible_unet`` at batch 12 and the remat ``unet`` at batch 64 from a
   fixed seed: no host sync inside a step, a gradient in every parameter (an
   exact zero in each bias that BatchNorm follows), running statistics that
   move once a step (against a no-grad forward from the state before it), a
   finite and falling loss, 42 conv-chain launches a remat U-Net step (21 in
   the backward's re-run) and none on the reversible paths, and the remat
   U-Net step bit-identical to the plain one from the same state and draws
   (cuDNN deterministic, resize as matrix products on both sides), and the
   first bf16 RevPHiSeg step against its f32 twin from the same weights and
   draws (loss and whole gradient, REV_STEP_GRAD_L2) with each side's
   parameter change equal to coupled-L2 Adam's first update written out from
   its own gradient (ADAM_OF_LR); (d) the
   peak memory of a float32 step in each mode, with cuDNN's TF32 off and on
   (``tools/torch_memory.py``: ``phiseg_7_5_12``'s shape at batch 12 and 24,
   the U-Net at 64), with remat and reversible below plain for PHiSeg at
   batch 12 in both; (e) each path's
   images/s and host issue time, and the 100-sample evaluation of one image
   by the bf16 ``phiseg_rev_7_5_12``;
9. the Probabilistic U-Net (``prob_unet``: a 7-level BN-free trunk, filters
   32/64/128/192/192/192/192, whose 13 blocks launch the conv-chain kernel
   39 times a forward; two BN encoders; ``latent_dim`` 6, ``no_convs_fcomb``
   3): (a) the float32 model at batch 2 on the card against the CPU, same
   weights and z noise, TF32 off, in eval mode (every output and, per
   tensor, every gradient) and train mode (outputs, loss terms, the whole
   gradient, running statistics), at phase 6's gates; (b) the 13 trunk
   block shapes at batch 12, kernel against plain in float32 and bf16 with
   each bf16 stage's plan, and the float32 kernel's time per block there
   and at the U-Net's 7 blocks, beside cuDNN f32 (TF32 off) and the bound
   at the f32 CUDA-core peak; (c) PROB_STEPS bf16 steps at batch 12 with
   device augmentation: 39 launches a step, no host sync, a finite loss,
   ``last_conv``'s gradient an exact zero and its change Adam's decay-only
   update written out, each BN-followed bias of the encoders and fcomb
   carrying the regularizer's term alone (REG_GRAD_RTOL), then ms a step,
   images/s, host issue ms and the phases; (d) the registered float32 step
   (39 launches of ``conv3x3_f32_fma``) beside the same step with the
   trunk on cuDNN f32; (e) ``eval_image`` of one image with 100 samples (78
   launches); (f) PROB_STEPS bf16 steps of ``prob_unet_reversible`` (no
   launch) with its evaluation; (g) ``train``/``validate``/``test`` on the
   synthetic LIDC data of phase 7.

Then a JSON line of the kernels (with per-block times, bounds and cuDNN's
times at both batches), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is non-zero; without a GPU the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

BATCH = 512
IMAGE = 128
FILTERS = (32, 64, 128, 192)
FORWARD_BATCHES = 3  # forwards of the counted main-path run
STAGES_PER_BLOCK = 3
# the 7 U-Net blocks at full width: (name, spatial size, C_in after the concat, C_out)
BLOCKS = [
    ("down0", 128, 1, 32), ("down1", 64, 32, 64), ("down2", 32, 64, 128),
    ("down3", 16, 128, 192), ("up2", 32, 320, 128), ("up1", 64, 192, 64),
    ("up0", 128, 96, 32),
]
# the shapes of tests/test_pallas.py: x shape, [(C_in, C_out) per stage]
TEST_SHAPES = [
    ((2, 16, 16, 4), [(4, 8), (8, 8), (8, 8)]),
    ((1, 8, 8, 2), [(2, 4)]),
    ((3, 20, 12, 4), [(4, 4), (4, 6)]),
    ((1, 33, 17, 3), [(3, 5), (5, 5), (5, 2)]),
]
# edges the main path does not reach: one pixel, images narrower or shorter
# than a tile, C_in not a multiple of 8 (the plain loader) over several K
# chunks, odd C_out; one full and one partial 64-channel chunk (C_in 96)
# into 192 output channels in one block, batch 1, 13x21 pixels; C_in = 1 on
# the plain loader, then 200 output channels in two blocks of 128
EDGE_SHAPES = [
    ((1, 1, 1, 37), [(37, 100)]),
    ((2, 5, 40, 9), [(9, 65), (65, 3)]),
    ((1, 17, 3, 16), [(16, 64), (64, 33)]),
    ((1, 13, 21, 96), [(96, 192), (192, 5)]),
    ((2, 19, 35, 1), [(1, 32), (32, 200)]),
]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W);
# float32 outside the tensor cores for the f32 kernel's CUDA-core FMA
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# the machine code every bf16 kernel instantiation must hold, and must not
SASS_REQUIRED = ("HGMMA", "UTMALDG")
SASS_FORBIDDEN = ("HMMA",)
# max |kernel - plain| <= F32_RTOL * max|plain|: both accumulate in f32 (TF32
# off), only the summation order differs
F32_RTOL = 1e-4
# bf16: the kernel rounds once per stage after the f32 bias add, the plain
# version also rounds cuDNN's conv output before it; allow BF16_ULPS ulps of
# max|plain| over the chain
BF16_ULPS = 4
# the bf16 main path against the plain path (bf16) or the f32 model, through
# 22 convs that each round to bf16: BF16_FORWARD_ULPS ulps of max|logit|
# (on an H100: 1 against the plain path, 2.3 against the f32 CPU model)
BF16_FORWARD_ULPS = 4
# the seed-0 model predicts class 1 at every pixel, so argmax agreement says
# nothing; the logit difference d = l1 - l0 varies with the input instead.
# In each image, rms(d_got - d_want) <= D_RTOL * std(d_want) over the batch
# (0.018 measured for bf16 against f32 on the CPU plain path)
D_RTOL = 0.05
# the forward's images/s with the first (mma.sync) kernel over thirteen
# calls (PERF.md) on an NVIDIA H100 80GB HBM3 at 700 W, printed beside each
# new reading
MMA_SYNC_FORWARD_IMAGES_S = (14583.1, 14855.4)
# launches of each block, at each batch, that must repeat the first bit for
# bit: the kernel's sums run in a fixed order, so any difference is a race
REPEATS = 100

# phase 5: the train step
TRAIN_BATCH = 64
TRAIN_STEPS = 30  # the counted main-path run; the loss must fall over it
PARITY_STEPS = 3  # kernel path vs plain path
TIME_STEPS = 10  # steps a timed round; 2 rounds, each after a warm-up step
# bf16 train step, each kernel-path step against the same step on a plain
# path from the same state and draws (``plain_chain``): step 1 on the plain
# version (on an NVIDIA H100 80GB HBM3 at 700 W: loss 2.1e-5, gradients
# 2.1e-2 of max|grad|), later steps on the kernel's own rounding
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL_OF_MAX = 0.06

# phase 6: PHiSeg
PHISEG_EXPERIMENT = "phiseg_7_5_12"
PHISEG_PARITY_BATCH = 2
PHISEG_STEPS = 30  # the loss must fall over them
PHISEG_SAMPLES = 100
# f32 card vs CPU, the same weights and eps. Eval mode (BatchNorm an affine
# map of the running statistics): every output and gradient within
# PHISEG_EVAL_OF_MAX of its max|ref|. Train mode: batch statistics over 8
# values a channel at the coarsest level amplify rounding with depth (at
# the published structure on the CPU, JAX against the port: outputs 5e-5 to
# 1.7e-4 of max, the whole gradient 5e-4 to 3.9e-3 relative L2,
# tests/test_torch_phiseg.py), so outputs within PHISEG_TRAIN_OF_MAX of
# max|ref|, the gradient as one vector within PHISEG_TRAIN_GRAD_L2, the
# running statistics within PHISEG_STATS_RTOL of each buffer's max; the loss terms within
# PHISEG_LOSS_RTOL in both modes
PHISEG_EVAL_OF_MAX = 1e-4
PHISEG_EVAL_GRAD_OF_MAX = 5e-3
PHISEG_TRAIN_OF_MAX = 1e-3
PHISEG_TRAIN_GRAD_L2 = 2e-2
PHISEG_STATS_RTOL = 1e-3
PHISEG_LOSS_RTOL = 1e-5

# phase 7: evaluation and the harness
EVAL_SAMPLES = 100  # the reference's quantitative protocol
EVAL_ANNOTATORS = 4
EVAL_TIMED_CALLS = 5  # fenced calls after a warm-up; the min is reported
EVAL_PARITY_SAMPLES = 16
# the metrics on the card against the CPU on the same inputs: intersections
# are exact counts in float32 and Dice a ratio of them (equal); GED sums
# the same distances in another order (GED_RTOL of max(1, |ref|)); NCC's
# means and standard deviations round differently (NCC_ATOL)
GED_RTOL = 1e-5
NCC_ATOL = 1e-4
# the harness on synthetic LIDC: (train, val, test) images, iterations,
# validation cadence and samples, and the test sweep's repeats and samples
HARNESS_SPLITS = (64, 8, 8)
HARNESS_ITERATIONS = 20
HARNESS_VALIDATION_FREQUENCY = 10
HARNESS_VALIDATION_SAMPLES = 16
HARNESS_TEST_REPEATS, HARNESS_TEST_SAMPLES = 2, 10

# phase 8: the memory modes
REV_EXPERIMENT = "phiseg_rev_7_5_12"
# the reversible blocks at full width: 192 channels at 8x8 (PHiSeg's coarse
# levels) and 64 at 128x128 (the widest tensor a coupling function sees),
# batch 12, 3 coupling blocks (a PHiSeg down block)
REV_BLOCK_SHAPES = [(12, 8, 8, 192), (12, 128, 128, 64)]
REV_DEPTH = 3
# f32, TF32 off: at 64 channels x 128x128 x batch 12 (196608 values a
# channel) float32 itself is far from exact: autograd's f32 input gradient
# lies 1.1e-2 of its max from a float64 run of the same chain (an NVIDIA
# H100 80GB HBM3 at 700 W; 1.8e-2 on a CPU), so no 1e-3-of-max gate holds
# against autograd there. Each of the Function's f32 gradients is held by
# its relative L2 distance from the float64 gradient: at most
# REV_F32_VS_AUTOGRAD times autograd's f32 distance plus 1e-5 (the
# reconstruction adds its own rounding to the earlier blocks: 1.81 times
# autograd's distance at worst, in the first block's f kernel, on that card;
# within 11% for every tensor on a CPU)
REV_F32_VS_AUTOGRAD = 3.0
# bf16: each reconstruction starts from outputs rounded to bf16, so the
# Function's gradient is held by its distance from the f32 gradient, at most
# REV_BF16_VS_AUTOGRAD times autograd's bf16 distance plus 0.01 (relative
# L2); the relative L2 against autograd's bf16 gradient is printed beside it
REV_BF16_VS_AUTOGRAD = 2.0
# bf16 steps of each memory-mode path from a fixed seed: RevPHiSeg's KL
# starts near 4e7 and swings for ~8 steps before it falls (an NVIDIA H100
# 80GB HBM3 at 700 W: 4.07e7, 1.34e9, ..., 2.06e8, 2.98e6, ... 7.4e5 at 12)
MODE_STEPS = 12
MODE_TIME_STEPS = 3  # steps a timed round; 2 rounds after those
REMAT_BATCH = 64
# the first bf16 RevPHiSeg step against its f32 twin from the same weights
# and draws: the whole gradient within REV_STEP_GRAD_L2 (relative L2) of the
# f32 one, and each step's parameter change within ADAM_OF_LR * lr of
# coupled-L2 Adam's first update written out from that step's own gradient
REV_STEP_GRAD_L2 = 0.3
ADAM_OF_LR = 1e-3


# phase 9: ProbUNet
PROB_EXPERIMENT = "prob_unet"
PROB_REV_EXPERIMENT = "prob_unet_reversible"
# the 13 trunk blocks of the 7-level prob_unet experiment at full width:
# (name, spatial size, C_in after the concat, C_out); 39 launches a forward
PROB_BLOCKS = [
    ("down0", 128, 1, 32), ("down1", 64, 32, 64), ("down2", 32, 64, 128), ("down3", 16, 128, 192),
    ("down4", 8, 192, 192), ("down5", 4, 192, 192), ("down6", 2, 192, 192), ("up5", 4, 384, 192),
    ("up4", 8, 384, 192), ("up3", 16, 384, 192), ("up2", 32, 320, 128), ("up1", 64, 192, 64),
    ("up0", 128, 96, 32),
]
PROB_LAUNCHES = len(PROB_BLOCKS) * STAGES_PER_BLOCK
PROB_BATCH = 12
# the batches at which the ProbUNet path runs its trunk: a sample's and a
# test image's loss forward (1), the train step (12), a validation image's
# loss repeats (validation_samples, 16)
PROB_CHECK_BATCHES = (1, PROB_BATCH, HARNESS_VALIDATION_SAMPLES)
PROB_STEPS = 12
# f32 card vs CPU in eval mode, each gradient tensor's relative L2 distance:
# single entries of the trunk's gradients move further than PHiSeg's (7.5e-3
# of the tensor's max|g| in up2's first conv, over phase 6's per-entry 5e-3;
# by relative L2 2.4e-3 at worst; an NVIDIA H100 80GB HBM3 at 700 W), where
# an entry is a sum that cancels or a pre-activation sits at ReLU's zero
PROB_EVAL_TENSOR_L2 = 1e-2
# the harness's train() for ProbUNet: a few steps and one validation. Its
# BN-free trunk's features outgrow the running statistics that eval-mode
# BatchNorm in the posterior net and fcomb uses, so sigma and the logits
# overflow and a validation's KL is NaN after 8 free f32 steps at batch 2,
# in the JAX package as in the port (CPU,
# tests/test_torch_prob_unet_validation.py), and after 20 bf16 steps at
# bs12 on the card (an NVIDIA H100 80GB HBM3 at 700 W)
PROB_HARNESS_ITERATIONS = 4
F32_BLOCK_ITERS = 20  # launches a timed round of one block in the f32 rows
# the gradient of a bias that BatchNorm follows is the regularizer's term
# alone, REG_WEIGHT * b / sqrt(sum(b^2) + 1e-12), written out here from b:
# within REG_GRAD_RTOL of the term's max|value| (the model sums the norms
# with multi-tensor kernels, in another order)
REG_GRAD_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(value: float) -> float:
    return 2.0 ** (math.floor(math.log2(value)) - 7)


def chain_weights(chans, gen, device, scale=None):
    ks, bs = [], []
    for ci, co in chans:
        std = scale if scale is not None else (2.0 / (9 * ci)) ** 0.5
        ks.append((torch.randn((co, ci, 3, 3), generator=gen) * std).to(device))
        bs.append((torch.randn((co,), generator=gen) * (1.0 if scale is not None else 0.1)).to(device))
    return ks, bs


def compare(conv_chain, x, ks, bs, label):
    """Kernel vs plain version on the same CUDA tensors; returns max |diff|."""
    out = conv_chain.fused_conv_chain(x, ks, bs)
    ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, f"{label}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(scale > 0, f"{label}: plain output is all zero")
    tol = F32_RTOL * scale if x.dtype == torch.float32 else BF16_ULPS * bf16_ulp(scale)
    log(f"[kernel] {label:<44} max|diff| {err:.3e}  max|ref| {scale:.3e}  tol {tol:.3e}")
    check(err <= tol, f"{label}: max|diff| {err} > tol {tol}")
    return err


def logits_agree(got, want, label):
    """Holds bf16 main-path logits (B, H, W, 2) against reference logits."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = BF16_FORWARD_ULPS * bf16_ulp(scale)
    d_got, d_want = got[..., 1] - got[..., 0], want[..., 1] - want[..., 0]
    spread = d_want.std().item()
    worst = ((d_got - d_want) ** 2).mean(dim=(1, 2)).sqrt().max().item() / spread
    share = (d_want > 0).float().mean().item()
    log(f"[slice] {label}: max|diff| {err:.3e}  max|ref| {scale:.3e}  tol {tol:.3e}; "
        f"d = l1 - l0: std {spread:.3e}, worst image rms(diff)/std {worst:.4f} (tol {D_RTOL}); "
        f"class-1 share {share:.4f}")
    check(err <= tol, f"{label}: max|diff| {err} > {tol}")
    check(worst <= D_RTOL, f"{label}: logit difference off by {worst} of its spread")


def plain_chain(kernel_rounding: bool = False):
    """Context in which every U-Net block runs a plain PyTorch chain,
    differentiable by autograd and computed from the f32 parameters, in
    place of the kernel: the chain's plain version
    (``fused_conv_chain_reference``, the JAX ``Conv``'s cast points), or with
    ``kernel_rounding`` the kernel's own function (bf16 operands, an f32
    conv with TF32 off, the f32 bias, ReLU, one rounding a stage), which
    differs from the kernel by the order of the f32 sums alone. The plain
    version also rounds the conv's output before the bias: after Adam's
    first update, whose lr * sign(g) grows the activations to ~35, that
    rounding alone moves a step's loss by 2.3e-3 with either kernel
    (PERF.md), the loss gate's whole width."""
    from unet_zoo_tpu_torch.ops import conv
    from unet_zoo_tpu_torch.ops.pallas import conv_chain

    def plain(x, ks, bs, packed=None):
        if not kernel_rounding:
            return conv_chain.fused_conv_chain_reference(x, ks, bs)
        for k, b in zip(ks, bs):
            y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), k.to(x.dtype).float(), padding=1)
            x = torch.relu(y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)
        return x

    return mock.patch.object(conv, "fused_conv_chain", plain)


def plain_path(model, x):
    """``model(x)`` with every block on the conv chain's plain version."""
    with plain_chain():
        return model(x)


def cudnn_chain(x, ks, bs):
    """The same chain as a PyTorch user would write it: cuDNN conv with the
    bias in x.dtype, then ReLU, per stage (NCHW channels_last view)."""
    y = x.permute(0, 3, 1, 2)
    for k, b in zip(ks, bs):
        y = torch.relu(torch.nn.functional.conv2d(y, k.to(x.dtype), b.to(x.dtype), padding=1))
    return y


def kernel_name(mangled: str) -> str:
    """conv3x3_bf16_wgmma<BN, KC> or conv3x3_f32_fma from a mangled name."""
    m = re.search(r"conv3x3_bf16_wgmmaILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"conv3x3_bf16_wgmma<{m.group(1)},{m.group(2)}>"
    return "conv3x3_f32_fma" if "conv3x3_f32_fma" in mangled else mangled


def ptxas_report(build_log: str) -> None:
    """Registers, spills and static shared memory per kernel, from ptxas -v."""
    name, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.split(":")[-1].strip() if ":" in line else line.strip()
        elif "Used" in line and name:
            log(f"[ptxas] {name}: {line.split('Used', 1)[1].strip()}; {spill}")
        if "C7518" in line or "serialized" in line:
            raise AssertionError(f"ptxas serialized the wgmma: {line.strip()}")


def find_cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME

    for tool in (shutil.which("cuobjdump"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "cuobjdump")):
        if tool and os.access(tool, os.X_OK):
            return tool
    return None


def sass_check(lib_path, build_log: str) -> dict:
    """Every bf16 kernel instantiation issues wgmma and TMA loads and no
    mma.sync: read from its machine code (cuobjdump -sass) where the toolkit
    has cuobjdump, else from the ptxas log (each bf16 entry compiled for
    sm_90a, which alone has wgmma, and no wgmma serialized). Returns
    {kernel: {op: count}}."""
    tool = find_cuobjdump()
    if tool is None:
        entries = [kernel_name(m) for m in re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'", build_log)]
        bf16 = [e for e in entries if e.startswith("conv3x3_bf16_wgmma")]
        check(len(bf16) == 12, f"ptxas compiled {len(bf16)} bf16 kernels for sm_90a, expected 12")
        log(f"[sass] no cuobjdump: ptxas compiled {len(bf16)} bf16 wgmma kernels for sm_90a, none serialized")
        return {e: {} for e in bf16}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = {op: 0 for op in SASS_REQUIRED + SASS_FORBIDDEN}
        elif name:
            for op in counts[name]:
                counts[name][op] += len(re.findall(rf"\b{op}\b", line))
    bf16 = {k: v for k, v in counts.items() if k.startswith("conv3x3_bf16_wgmma")}
    check(len(bf16) == 12, f"{len(bf16)} bf16 kernels in the library's machine code, expected 12")
    for k, v in bf16.items():
        log(f"[sass] {k}: " + ", ".join(f"{op} {n}" for op, n in v.items()))
        check(all(v[op] > 0 for op in SASS_REQUIRED) and not any(v[op] for op in SASS_FORBIDDEN),
              f"{k}: machine code {v}, needs {SASS_REQUIRED} and none of {SASS_FORBIDDEN}")
    return bf16


def chain_cost(batch, size, chans, itemsize: int = 2):
    """(FLOPs, bytes) of a chain: 2*9*C_in*C_out a pixel and stage; the
    chain's input and output read and written once, and its weights, all of
    ``itemsize`` bytes (bf16 by default)."""
    pixels = batch * size * size
    flops = sum(2 * 9 * ci * co * pixels for ci, co in chans)
    nbytes = itemsize * (pixels * (chans[0][0] + chans[-1][1]) + sum(9 * ci * co for ci, co in chans))
    return flops, nbytes


def bound(flops, nbytes, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time in ms the card could take at ``peak_flops``: (ms,
    "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_blocks(conv_chain, model, batch, cuda_gen, dev, card) -> list:
    """Each block at ``batch`` on the model's weights: the kernel against its
    plain version, REPEATS launches against the first, then the kernel's, the plain version's and cuDNN's times
    (CUDA events, the min of 2 rounds), its bound and TFLOP/s. Returns one
    record a block."""
    iters = 5 * BATCH // batch
    rows = []
    with torch.inference_mode():
        for block, size, ci, co in BLOCKS:
            convs = [m.conv for m in getattr(model, block).convs.children()]
            ks, bs = [c.weight for c in convs], [c.bias for c in convs]
            x = torch.randn((batch, size, size, ci), generator=cuda_gen, device=dev).to(torch.bfloat16)
            err = compare(conv_chain, x, ks, bs, f"bf16 {block} ({batch}, {size}, {size}, {ci})->{co}")
            packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
            first = conv_chain.fused_conv_chain(x, ks, bs, packed=packed)
            differ = sum(not torch.equal(conv_chain.fused_conv_chain(x, ks, bs, packed=packed), first)
                         for _ in range(REPEATS))
            log(f"[repeat] {block} bs{batch}: {REPEATS - differ} of {REPEATS} repeated launches bit-identical "
                f"to the first")
            check(differ == 0, f"{block} bs{batch}: {differ} of {REPEATS} repeated launches differ from the first")
            k_ms, p_ms, c_ms = [], [], []
            for _ in range(2):
                k_ms.append(cuda_ms(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), iters))
                p_ms.append(cuda_ms(lambda: conv_chain.fused_conv_chain_reference(x, ks, bs), iters))
                c_ms.append(cuda_ms(lambda: cudnn_chain(x, ks, bs), iters))
            k, p, c = min(k_ms), min(p_ms), min(c_ms)
            chans = [(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1)
            flops, nbytes = chain_cost(batch, size, chans)
            b_ms, b_by = bound(flops, nbytes)
            stage_ms = sum(bound(*chain_cost(batch, size, [st]))[0] for st in chans)
            tflops = flops / (k * 1e-3) / 1e12
            rows.append({"block": block, "batch": batch, "ms": k, "plain_ms": p, "library_ms": c,
                         "bound_ms": b_ms, "bound_by": b_by, "stage_bound_ms": stage_ms,
                         "share_of_bound": b_ms / k, "tflops": tflops, "max_abs_err": err})
            log(f"[time] {block} ({batch}, {size}, {size}, {ci})->{co} x3 bf16: kernel {k:.3f} ms "
                f"({tflops:.1f} TFLOP/s, {b_ms / k:.1%} of its {b_ms:.3f} ms bound by {b_by}; the stages' own "
                f"bounds sum to {stage_ms:.3f}), plain {p:.3f} ms, cuDNN conv+bias+ReLU {c:.3f} ms | card: {card}")
            del x
    k, b, p, c = (sum(r[key] for r in rows) for key in ("ms", "bound_ms", "plain_ms", "library_ms"))
    log(f"[time] 7 blocks bs{batch}: kernel {k:.3f} ms ({b / k:.1%} of the {b:.3f} ms bound), plain {p:.3f} ms, "
        f"cuDNN conv+bias+ReLU {c:.3f} ms; kernel/cuDNN {k / c:.3f} | card: {card}")
    return rows


def launch_host_us(conv_chain, model, dev) -> float:
    """Host microseconds to issue one bf16 stage (plan, tensor maps, launch)
    at down2's bs512 shape: the min of 5 rounds of 7 chains of 3 stages."""
    convs = [m.conv for m in model.down2.convs.children()]
    ks, bs = [c.weight for c in convs], [c.bias for c in convs]
    x = torch.randn((BATCH, 32, 32, 64), device=dev).to(torch.bfloat16)
    packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
    best = math.inf
    with torch.inference_mode():
        conv_chain.fused_conv_chain(x, ks, bs, packed=packed)
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(7):
                conv_chain.fused_conv_chain(x, ks, bs, packed=packed)
            best = min(best, (time.perf_counter() - t0) / 21 * 1e6)
        torch.cuda.synchronize()
    return best


def function_grads_agree(conv_chain, dev, gen) -> float:
    """The chain's autograd Function on the card against autograd of the
    plain version, float32 with TF32 off: each input, kernel and bias
    gradient within F32_RTOL of its max|grad|."""
    worst = 0.0
    for shape, chans in TEST_SHAPES + EDGE_SHAPES:
        x = torch.randn(shape, generator=gen).to(dev).requires_grad_()
        ks, bs = chain_weights(chans, gen, dev, scale=0.2 if (shape, chans) in TEST_SHAPES else None)
        leaves = [x, *(t.requires_grad_() for t in ks), *(t.requires_grad_() for t in bs)]
        g = torch.randn((*shape[:3], chans[-1][1]), generator=gen).to(dev)
        before = conv_chain.launches
        out = conv_chain.fused_conv_chain(x, ks, bs)
        check(conv_chain.launches == before + len(chans), f"{shape}: {conv_chain.launches - before} launches")
        check(type(out.grad_fn).__name__.startswith("FusedConvChain"), f"grad_fn {out.grad_fn}")
        got = torch.autograd.grad((out * g).sum(), leaves)
        want = torch.autograd.grad((conv_chain.fused_conv_chain_reference(x, ks, bs) * g).sum(), leaves)
        torch.cuda.synchronize()
        for name, a, b in zip(["x"] + [f"k{j}" for j in range(len(ks))] + [f"b{j}" for j in range(len(bs))],
                              got, want):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            check(scale > 0 and err <= F32_RTOL * scale, f"{shape} {chans} grad {name}: {err} vs max {scale}")
            worst = max(worst, err / scale)
        log(f"[train] f32 Function backward {shape} {chans}: grads of x, kernels, biases agree with "
            f"the plain version's autograd")
    log(f"[train] f32 Function backward: worst max|diff|/max|grad| {worst:.3e} (tol {F32_RTOL})")
    return worst


def train_batches(n: int, dev, batch: int = TRAIN_BATCH):
    """n batches of (batch, IMAGE, IMAGE, 1) noise from a fixed seed,
    labelled where a 9x9 box blur of the image is positive: a map a U-Net
    can learn, so the loss can fall."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n * batch, 1, IMAGE, IMAGE), generator=gen, device=dev)
    y = torch.nn.functional.avg_pool2d(x, 9, 1, 4) > 0
    return (x.view(n, batch, IMAGE, IMAGE, 1), y.view(n, batch, IMAGE, IMAGE).long())


def train_slice(conv_chain, dev, card: str, log_dir: str) -> dict:
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16")
    opts = cfg.augmentation_options
    xs, ys = train_batches(TRAIN_STEPS, dev)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    params = dict(trainer.state.model.named_parameters())
    per_step = len(BLOCKS) * STAGES_PER_BLOCK

    # the counted main-path run: TRAIN_STEPS steps
    torch.cuda.synchronize()
    conv_chain.launches = 0
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    check(conv_chain.launches == per_step, f"first train step launched {conv_chain.launches}, expected {per_step}")
    # every conv weight and bias has a gradient, and none is all zero
    convs = [n for n in params if n != "last.weight" and n != "last.bias"]
    dead = [n for n, p in params.items() if p.grad is None or not bool(p.grad.ne(0).any())]
    check(not dead, f"no gradient in {dead}")
    log(f"[train] step 1: {per_step} kernel launches; non-zero gradients in all {len(params)} parameters "
        f"({len(convs) // 2} block convs + the 1x1 last conv, weight and bias each)")
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside a step raises
    for i in range(1, TRAIN_STEPS):
        losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = conv_chain.launches
    check(launched == TRAIN_STEPS * per_step, f"{TRAIN_STEPS} train steps launched {launched}")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    tail = losses[-5:].mean().item()
    log(f"[train] {TRAIN_STEPS} steps bs{TRAIN_BATCH} {IMAGE}x{IMAGE} bf16, device augmentation: "
        f"{launched} kernel launches (expected {TRAIN_STEPS * per_step}), no host sync inside a step; "
        f"loss {losses[0]:.4f} -> mean of the last 5 {tail:.4f}; lr {trainer.state.sched.lr.item():.2e}")
    log(f"[train] losses: {' '.join(f'{v:.4f}' for v in losses.tolist())}")
    check(tail < losses[0].item(), f"loss did not fall: {losses[0]:.4f} -> {tail:.4f}")

    # each of PARITY_STEPS kernel-path steps against the same step on a plain
    # path from the same state (the kernel path's) and draws. Step 1 holds
    # the loss and every gradient, so the Function's backward, against the
    # plain version and its autograd. Later steps hold the loss against the
    # kernel's own rounding: along two separate trajectories the losses from
    # step 2 on read chance, since step-1 gradients that differ by 1-2% of
    # max|grad| (a ReLU mask flipped where the f32 sums land on 0, the
    # library backward's atomics) give Adam's first update, lr * sign(g),
    # other signs wherever a gradient is near 0 (PERF.md). The plain side
    # reads the f32 parameters, never the kernel's packed copies, so packed
    # weights left one step stale would move the kernel's loss alone.
    kern, plain = Trainer(cfg, dev, seed=1, log_dir=log_dir), Trainer(cfg, dev, seed=1, log_dir=log_dir)
    aug_gen = torch.Generator(device=dev).manual_seed(4)
    for i in range(PARITY_STEPS):
        if i:  # a copy: the optimizer would keep the live moment tensors
            plain.state.load_state_dict(copy.deepcopy(kern.state.state_dict()))
        draws = sample_augment_params(aug_gen, TRAIN_BATCH, (IMAGE, IMAGE), opts, dev)
        lk = kern.train_step(xs[i], ys[i], draws)["loss"].item()
        with plain_chain(kernel_rounding=i > 0):
            lp = plain.train_step(xs[i], ys[i], draws)["loss"].item()
        what = "plain stages of the kernel's rounding" if i else "plain path"
        rel = abs(lk - lp) / abs(lp)
        log(f"[train] step {i + 1}, kernel vs {what}: loss {lk:.6f} vs {lp:.6f}, rel diff {rel:.2e} "
            f"(tol {TRAIN_LOSS_RTOL})")
        check(rel <= TRAIN_LOSS_RTOL, f"step {i + 1} loss: kernel {lk} vs {what} {lp}")
        if i == 0:
            worst, worst_rms = 0.0, 0.0
            for (name, pk), pp in zip(kern.state.model.named_parameters(), plain.state.model.parameters()):
                a, b = pk.grad.float(), pp.grad.float()
                scale = b.abs().max().item()
                err = (a - b).abs().max().item() / scale
                rms = ((a - b).norm() / b.norm()).item()
                worst, worst_rms = max(worst, err), max(worst_rms, rms)
                check(err <= TRAIN_GRAD_RTOL_OF_MAX, f"step 1 grad {name}: max|diff| {err:.3e} of max|grad|")
            log(f"[train] step 1 gradients, kernel path vs plain path's autograd, worst over the {len(params)} "
                f"tensors: max|diff|/max|grad| {worst:.3e} (tol {TRAIN_GRAD_RTOL_OF_MAX}), |diff|/|grad| "
                f"{worst_rms:.3e}")
    # weights one step stale would move a step's loss by what one update
    # moves it on a fixed batch; the loss gate must be able to see that
    with torch.no_grad():
        moved = abs(kern.forward_loss(*kern.augment(xs[i], ys[i], draws))[0].item() - lk) / lk
    log(f"[train] one update moves the step-{PARITY_STEPS} loss by {moved:.2e} relative on its own batch: "
        f"{moved / TRAIN_LOSS_RTOL:.1f}x the loss tolerance, so packed weights one step stale would fail the gate")
    check(moved > 2 * TRAIN_LOSS_RTOL, f"one update moves the loss by only {moved:.2e}")
    del kern, plain

    # times: CUDA events after a warm-up step, the min of 2 rounds of TIME_STEPS steps
    def step_ms(tr) -> float:
        return min(cuda_ms(lambda: tr.train_step(xs[0], ys[0]), TIME_STEPS) for _ in range(2))

    def host_ms(tr) -> float:
        # the step makes no host sync, so from an idle device the call
        # returns once every launch is queued: the host's time to issue it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(xs[0], ys[0])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3

    kernel_ms = step_ms(trainer)
    with plain_chain():
        plain_trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
        plain_ms = step_ms(plain_trainer)
    # alternating the paths, so that both meet the same host
    kernel_hosts, plain_hosts = [], []
    for _ in range(TIME_STEPS):
        kernel_hosts.append(host_ms(trainer))
        with plain_chain():
            plain_hosts.append(host_ms(plain_trainer))
    kernel_host, plain_host = min(kernel_hosts), min(plain_hosts)
    log(f"[time] train step bs{TRAIN_BATCH} {IMAGE}x{IMAGE} bf16 with device augmentation: kernel path "
        f"{kernel_ms:.3f} ms, {TRAIN_BATCH / kernel_ms * 1e3:.1f} images/s; plain path {plain_ms:.3f} ms, "
        f"{TRAIN_BATCH / plain_ms * 1e3:.1f} images/s | card: {card}")
    log(f"[time] host time to issue one train step onto an idle device, min / median of {TIME_STEPS}: "
        f"kernel path {kernel_host:.3f} / {sorted(kernel_hosts)[TIME_STEPS // 2]:.3f} ms, plain path "
        f"{plain_host:.3f} / {sorted(plain_hosts)[TIME_STEPS // 2]:.3f} ms; where it reaches the step "
        f"time, the host sets the pace | card: {card}")
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(TIME_STEPS)]
    for ev in events:
        ev[0].record()
        x, y = trainer.augment(xs[0], ys[0])
        ev[1].record()
        loss, _ = trainer.forward_loss(x, y)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update(loss)
        ev[4].record()
    torch.cuda.synchronize()
    phases = [sum(ev[k].elapsed_time(ev[k + 1]) for ev in events) / TIME_STEPS for k in range(4)]
    log(f"[time] train step phases, kernel path, ms/step: augmentation {phases[0]:.3f}, forward+loss "
        f"{phases[1]:.3f}, backward {phases[2]:.3f}, optimizer+plateau {phases[3]:.3f} | card: {card}")
    return {"launches": launched, "ms": kernel_ms, "plain_ms": plain_ms,
            "host_ms": kernel_host, "plain_host_ms": plain_host}


def phiseg_run(model, x, y, post_eps, prior_eps, train: bool):
    """One forward with the mask, the loss and its gradients, in train or
    eval mode: (outputs, aux, {parameter: grad})."""
    model.train(train)
    model.zero_grad(set_to_none=True)
    out = model(x, y, post_eps=post_eps, prior_eps=prior_eps)
    loss, aux = model.loss(out, y)
    loss.backward()
    return out, aux, {n: p.grad for n, p in model.named_parameters()}


def phiseg_parity(dev, experiment: str = PHISEG_EXPERIMENT, modes=(True, False)) -> None:
    """(a): float32, the same weights and z noise on the card and the CPU, in
    train mode (``True`` in ``modes``) and eval mode (``False``)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    cfg = get_experiment(experiment)
    models = {d: get_model("phiseg", **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((PHISEG_PARITY_BATCH, IMAGE, IMAGE, 1), generator=gen)
    y = (torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4) > 0)[:, 0].long()
    eps = {kind: [torch.randn((PHISEG_PARITY_BATCH, IMAGE >> (lvl + 2), IMAGE >> (lvl + 2), cfg.zdim), generator=gen)
                  for lvl in range(cfg.latent_levels)] for kind in ("post", "prior")}
    for train in modes:
        mode = "train" if train else "eval"
        if not train:  # the same running statistics on both sides
            models[dev].load_state_dict(models["cpu"].state_dict())
        runs = {}
        for d, m in models.items():
            to = (lambda t: t.to(d))  # noqa: E731
            runs[d] = phiseg_run(m, to(x), to(y), [to(e) for e in eps["post"]], [to(e) for e in eps["prior"]], train)
        (out_c, aux_c, g_c), (out_g, aux_g, g_g) = runs["cpu"], runs[dev]
        of_max = PHISEG_TRAIN_OF_MAX if train else PHISEG_EVAL_OF_MAX
        out_err = 0.0
        for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma"):
            for lvl, (a, b) in enumerate(zip(out_g[key], out_c[key])):
                err = (a.detach().cpu() - b.detach()).abs().max().item() / b.detach().abs().max().item()
                out_err = max(out_err, err)
                check(err <= of_max, f"f32 {mode} {key}[{lvl}]: {err:.3e} of max|ref| > {of_max}")
        loss_err = 0.0
        for key in ("loss", "kl", "recon"):
            err = abs(aux_g[key].item() - aux_c[key].item()) / abs(aux_c[key].item())
            loss_err = max(loss_err, err)
            check(err <= PHISEG_LOSS_RTOL, f"f32 {mode} {key}: rel diff {err:.3e} > {PHISEG_LOSS_RTOL}")
        for n in g_c:
            check(g_c[n] is not None and g_g[n] is not None, f"f32 {mode}: no gradient in {n}")
        per_tensor, worst_name = max((((g_g[n].cpu() - g_c[n]).abs().max() / g_c[n].abs().max()).item(), n)
                                     for n in g_c if g_c[n].any())
        flat = {d: torch.cat([g[n].detach().cpu().flatten() for n in g_c]) for d, g in (("cpu", g_c), (dev, g_g))}
        l2 = ((flat[dev] - flat["cpu"]).norm() / flat["cpu"].norm()).item()
        if train:
            check(l2 <= PHISEG_TRAIN_GRAD_L2, f"f32 train gradient: rel L2 {l2:.3e} > {PHISEG_TRAIN_GRAD_L2}")
            gpu_buffers = dict(models[dev].named_buffers())
            stats_err = max(((gpu_buffers[n].cpu() - b).abs().max() / b.abs().max()).item()
                            for n, b in models["cpu"].named_buffers())
            check(stats_err <= PHISEG_STATS_RTOL, f"running statistics: rel diff {stats_err:.3e}")
            tol = f"tol L2 {PHISEG_TRAIN_GRAD_L2}); running statistics rel {stats_err:.3e} (tol {PHISEG_STATS_RTOL}"
        else:
            check(per_tensor <= PHISEG_EVAL_GRAD_OF_MAX, f"f32 eval gradient {worst_name}: {per_tensor:.3e} of max|g|")
            tol = f"tol {PHISEG_EVAL_GRAD_OF_MAX}"
        log(f"[phiseg] {experiment} f32 {mode} mode, card vs CPU, batch {PHISEG_PARITY_BATCH}, {len(g_c)} gradients: outputs "
            f"{out_err:.3e} of max|ref| (tol {of_max}), loss/kl/recon rel {loss_err:.3e} (tol {PHISEG_LOSS_RTOL}), "
            f"gradient rel L2 {l2:.3e}, worst tensor {worst_name} {per_tensor:.3e} of its max|g| ({tol})")
    del models


def step_times(trainer, x, y, n: int) -> dict:
    """The train step's times on one batch: ``ms`` (CUDA events, the min of
    2 rounds of ``n`` steps), the host's time to issue one step onto an idle
    device (``host_ms`` the min of ``n``, ``host_median_ms``), and the ms of
    each phase a step (``phases_ms``: augmentation, forward+loss, backward,
    optimizer+plateau, over ``n`` steps)."""
    ms = min(cuda_ms(lambda: trainer.train_step(x, y), n) for _ in range(2))
    hosts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(x, y)
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(n)]
    for ev in events:
        ev[0].record()
        xa, ya = trainer.augment(x, y)
        ev[1].record()
        loss, _ = trainer.forward_loss(xa, ya)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update(loss)
        ev[4].record()
    torch.cuda.synchronize()
    phases = [sum(ev[k].elapsed_time(ev[k + 1]) for ev in events) / n for k in range(4)]
    return {"ms": ms, "host_ms": min(hosts), "host_median_ms": sorted(hosts)[n // 2], "phases_ms": phases}


def phiseg_slice(conv_chain, dev, card: str, log_dir: str) -> None:
    """(b) and (c): the bf16 phiseg_7_5_12 train step, its times, and sample()."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(PHISEG_EXPERIMENT), dtype="bfloat16")
    xs, ys = train_batches(PHISEG_STEPS, dev, cfg.batch_size)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    model = trainer.state.model
    params = dict(model.named_parameters())
    heads = {f"likelihood.head{j}.conv.bias" for j in range(cfg.latent_levels)}
    free = [n for n in params if n.endswith("conv.bias") and n not in heads]
    before = {n: params[n].detach().clone() for n in free}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}

    torch.cuda.synchronize()
    conv_chain.launches = 0
    t0 = time.perf_counter()
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    missing = [n for n, p in params.items() if p.grad is None]
    check(not missing, f"no gradient in {missing}")
    nonzero = [n for n in free if bool(params[n].grad.ne(0).any())]
    check(not nonzero, f"conv biases before BatchNorm with a non-zero gradient: {nonzero}")
    still = [n for n in free if torch.equal(params[n].detach(), before[n])]
    check(not still, f"conv biases before BatchNorm that Adam did not move: {still}")
    dead = [n for n in params if n not in free and not bool(params[n].grad.ne(0).any())]
    check(not dead, f"all-zero gradient in {dead}")
    log(f"[phiseg] step 1 ({first_s:.2f} s with warm-up): gradients in all {len(params)} parameters; the "
        f"{len(free)} conv biases that BatchNorm follows have an exact zero gradient and moved by Adam's weight "
        f"decay alone")
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside a step raises
    for i in range(1, PHISEG_STEPS):
        losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(conv_chain.launches == 0, f"the PHiSeg step launched the conv-chain kernel {conv_chain.launches} times")
    same = [n for n, b in model.named_buffers() if torch.equal(b, stats0[n])]
    check(not same, f"running statistics that did not change: {same}")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    tail = losses[-5:].mean().item()
    log(f"[phiseg] {PHISEG_STEPS} steps bs{cfg.batch_size} {IMAGE}x{IMAGE} bf16, device augmentation: no host "
        f"sync inside a step, {conv_chain.launches} conv-chain launches, {len(stats0)} running statistics all "
        f"changed; loss {losses[0]:.2f} -> mean of the last 5 {tail:.2f}")
    log(f"[phiseg] losses: {' '.join(f'{v:.2f}' for v in losses.tolist())}")
    check(tail < losses[0].item(), f"loss did not fall: {losses[0]:.2f} -> {tail:.2f}")

    t = step_times(trainer, xs[0], ys[0], TIME_STEPS)
    phases = t["phases_ms"]
    log(f"[time] PHiSeg train step bs{cfg.batch_size} {IMAGE}x{IMAGE} bf16 with device augmentation: "
        f"{t['ms']:.3f} ms, {cfg.batch_size / t['ms'] * 1e3:.1f} images/s | card: {card}")
    log(f"[time] PHiSeg host time to issue one train step onto an idle device, min / median of {TIME_STEPS}: "
        f"{t['host_ms']:.3f} / {t['host_median_ms']:.3f} ms | card: {card}")
    log(f"[time] PHiSeg train step phases, ms/step: augmentation {phases[0]:.3f}, forward+loss {phases[1]:.3f}, "
        f"backward {phases[2]:.3f}, optimizer+plateau {phases[3]:.3f} | card: {card}")

    x1 = xs[0][:1]
    with torch.inference_mode():
        samples = model.sample(x1, PHISEG_SAMPLES)
        sample_ms = min(cuda_ms(lambda: model.sample(x1, PHISEG_SAMPLES), 3) for _ in range(2))
    check(samples.shape == (1, PHISEG_SAMPLES, IMAGE, IMAGE, cfg.n_classes) and samples.dtype == torch.bfloat16,
          f"samples {tuple(samples.shape)} {samples.dtype}")
    check(bool(torch.isfinite(samples).all()), "non-finite samples")
    spread = samples.float().std(dim=1).mean().item()
    check(spread > 0, "the samples are all the same")
    log(f"[time] PHiSeg sample(x, {PHISEG_SAMPLES}) at batch 1 bf16: {sample_ms:.3f} ms an image (logits "
        f"{tuple(samples.shape)}, mean std over the samples {spread:.3e}) | card: {card}")


def metric_inputs(n_classes: int, n: int, seed: int):
    """Fixed inputs at the evaluation's shape: logits (n, IMAGE, IMAGE, C)
    whose argmax is each sample's labels, with two samples all background,
    and EVAL_ANNOTATORS annotators' blobs, the last one empty."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMAGE, 0:IMAGE]
    logits = rng.standard_normal((n, IMAGE, IMAGE, n_classes)).astype(np.float32)
    for c in range(1, n_classes):
        cy, cx = rng.uniform(0.3, 0.7, 2) * IMAGE
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.15 * IMAGE) ** 2).astype(np.float32)
        logits[..., c] += 3.0 * blob
    logits[:2, ..., 0] += 10.0
    y_all = np.zeros((EVAL_ANNOTATORS, IMAGE, IMAGE), np.int64)
    for a in range(EVAL_ANNOTATORS - 1):
        for c in range(1, n_classes):
            cy, cx = rng.uniform(0.3, 0.7, 2) * IMAGE
            y_all[a][(yy - cy) ** 2 + (xx - cx) ** 2 < (rng.uniform(0.08, 0.2) * IMAGE) ** 2] = c
    return torch.from_numpy(logits), torch.from_numpy(y_all)


def metrics_agree(got: dict, want: dict, label: str) -> None:
    """GED, NCC and Dice of one evaluation against a reference's, at (a)'s tolerances."""
    ged_tol = GED_RTOL * max(1.0, abs(want["ged"].item()))
    ged_err = abs(got["ged"].item() - want["ged"].item())
    ncc_err = abs(got["ncc"].item() - want["ncc"].item())
    check(ged_err <= ged_tol, f"{label}: GED {got['ged'].item()} vs {want['ged'].item()}")
    check(ncc_err <= NCC_ATOL, f"{label}: NCC {got['ncc'].item()} vs {want['ncc'].item()}")
    check(torch.equal(got["dice"].cpu(), want["dice"].cpu()), f"{label}: Dice {got['dice']} vs {want['dice']}")
    log(f"[eval] {label}: GED {want['ged'].item():.6f} |diff| {ged_err:.2e} (tol {ged_tol:.1e}), NCC "
        f"{want['ncc'].item():.6f} |diff| {ncc_err:.2e} (tol {NCC_ATOL}), Dice equal")


def metrics_parity(dev) -> None:
    """(a): each metric on the card against the CPU on the same inputs."""
    from unet_zoo_tpu_torch import metrics as M

    for n_classes in (2, 3):
        logits, y_all = metric_inputs(n_classes, EVAL_SAMPLES, seed=n_classes)
        probs = torch.softmax(logits, dim=-1)
        labels = logits.argmax(-1)
        gt = torch.nn.functional.one_hot(y_all, n_classes).float()
        stacked = torch.cat([labels, y_all])
        label_range = range(1, n_classes)
        empty = 0
        for lbl in label_range:
            (ic, sc), (ig, sg) = (M.pairwise_intersections(t, lbl) for t in (stacked, stacked.to(dev)))
            check(torch.equal(ig.cpu(), ic) and torch.equal(sg.cpu(), sc), f"{n_classes} classes, label {lbl}: "
                  f"intersections differ by up to {(ig.cpu() - ic).abs().max().item()}")
            empty += int((sc == 0).sum().item())
        runs = {}
        for d in ("cpu", dev):
            to = (lambda t: t.to(d))  # noqa: E731
            runs[d] = {
                "ged": M.generalised_energy_distance(to(labels), to(y_all), n_classes - 1, label_range),
                "ncc": M.variance_ncc_dist_class_first(to(probs.movedim(-1, 0)), to(gt.movedim(-1, 0))),
                "ncc_last": M.variance_ncc_dist(to(probs), to(gt)),
                "dice": torch.stack([M.dice_per_label(to(labels[i]), to(y_all[a]), n_classes)
                                     for i in (0, 2, 3) for a in range(EVAL_ANNOTATORS)]),
            }
        metrics_agree(runs[dev], runs["cpu"], f"metrics card vs CPU, {EVAL_SAMPLES} samples x {EVAL_ANNOTATORS} "
                                              f"annotators {IMAGE}x{IMAGE}, {n_classes} classes, {empty} empty masks; "
                                              f"intersections exact")
        err = abs(runs[dev]["ncc_last"].item() - runs["cpu"]["ncc_last"].item())
        check(err <= NCC_ATOL, f"{n_classes} classes: channels-last NCC |diff| {err}")


def eval_timing(conv_chain, dev, card: str, log_dir: str, experiment: str = PHISEG_EXPERIMENT,
                launches: int = 0, finite: bool = True) -> dict:
    """(b): the 100-sample evaluation of one image by bf16 ``experiment``,
    which must launch the conv-chain kernel ``launches`` times. Without
    ``finite`` (a model whose eval-mode outputs overflow) the eval-mode loss
    and NCC are logged and not held finite."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer, image_metrics

    cfg = dataclasses.replace(get_experiment(experiment), dtype="bfloat16")
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((1, IMAGE, IMAGE, 1), generator=gen, device=dev)
    y_all = torch.randint(0, cfg.n_classes, (EVAL_ANNOTATORS, IMAGE, IMAGE), generator=gen, device=dev)
    torch.cuda.synchronize()
    conv_chain.launches = 0
    out = trainer.eval_image(x, y_all, y_all[:1], EVAL_SAMPLES)  # warm-up
    torch.cuda.synchronize()
    launched = conv_chain.launches
    check(launched == launches, f"the {experiment} evaluation launched the conv-chain kernel {launched} times, "
                                f"expected {launches}")
    walls, hosts = [], []
    for i in range(EVAL_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.eval_image(x, y_all, y_all[:1], EVAL_SAMPLES, index=i + 1)
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ged, ncc, dice = out["ged"].item(), out["ncc"].item(), out["dice"].cpu()
    check(math.isfinite(ged) and (math.isfinite(out["loss"].item()) or not finite),
          f"GED {ged}, loss {out['loss'].item()}")
    check(-1.0 <= ncc <= 1.0 or (math.isnan(ncc) and not finite), f"NCC {ncc} outside [-1, 1]")
    check(bool(((dice >= 0) & (dice <= 1)).all()), f"Dice {dice.tolist()} outside [0, 1]")
    ms, host = min(walls), min(hosts)

    # where the time goes: each part alone, fenced, the min of 3
    def fenced_ms(fn) -> float:
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    model, generator = trainer.state.model, trainer.eval_generator(0, 0)
    model.eval()
    with torch.inference_mode():
        logits = model.sample(x, EVAL_SAMPLES, generator=generator)
        parts = {
            f"sample(x, {EVAL_SAMPLES})": fenced_ms(lambda: model.sample(x, EVAL_SAMPLES, generator=generator)),
            "GED/NCC/Dice": fenced_ms(lambda: image_metrics(logits[0], y_all, y_all[0])),
            "eval-mode loss forward": fenced_ms(lambda: model.loss(model(x, y_all[:1], generator=generator),
                                                                   y_all[:1])),
        }
    model.train()
    log(f"[time] {experiment} {EVAL_SAMPLES}-sample evaluation, each part alone (fenced, min of 3): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()) + f" | card: {card}")
    log(f"[eval] {experiment} bf16, {EVAL_SAMPLES} samples + GED/NCC/Dice + loss of one image ({launched} "
        f"conv-chain launches): GED {ged:.4f} NCC {ncc:.4f} Dice {[round(v, 4) for v in dice.tolist()]} loss "
        f"{out['loss'].item():.1f}")
    log(f"[time] {experiment} {EVAL_SAMPLES}-sample evaluation bf16, one {IMAGE}x{IMAGE} image: {ms:.3f} ms an image "
        f"(min of {EVAL_TIMED_CALLS} fenced calls, median {sorted(walls)[EVAL_TIMED_CALLS // 2]:.3f}); the host "
        f"issues it in {host:.3f} ms (median {sorted(hosts)[EVAL_TIMED_CALLS // 2]:.3f}) | card: {card}")
    return {"ms": ms, "host_ms": host, "parts_ms": parts, "launches": launched}


def eval_parity(dev, log_dir: str) -> None:
    """(c): float32 phiseg_7_5_12 evaluation of one image, card vs CPU."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer, image_metrics

    cfg = get_experiment(PHISEG_EXPERIMENT)
    trainers = {d: Trainer(cfg, d, seed=5, log_dir=log_dir) for d in ("cpu", dev)}
    n = EVAL_PARITY_SAMPLES
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((1, IMAGE, IMAGE, 1), generator=gen)
    _, y_all = metric_inputs(cfg.n_classes, 1, seed=9)
    shapes = [(IMAGE >> (lvl + 2),) * 2 + (cfg.zdim,) for lvl in range(cfg.latent_levels)]
    eps = [torch.randn((1, n, *s), generator=gen) for s in shapes]
    loss_eps = tuple([torch.randn((1, *s), generator=gen) for s in shapes] for _ in range(2))
    logits, outs = {}, {}
    for d, tr in trainers.items():
        to = (lambda t: t.to(d))  # noqa: E731
        with torch.inference_mode():
            logits[d] = tr.state.model.sample(to(x), n, eps=[to(e) for e in eps])[0].cpu()
        outs[d] = tr.eval_image(to(x), to(y_all), to(y_all[:1]), n, eps=[to(e) for e in eps],
                                loss_eps=tuple([to(e) for e in le] for le in loss_eps))
    err = (logits[dev] - logits["cpu"]).abs().max().item() / logits["cpu"].abs().max().item()
    flips = int((logits[dev].argmax(-1) != logits["cpu"].argmax(-1)).sum().item())
    log(f"[eval] f32 {PHISEG_EXPERIMENT} sample(x, {n}) card vs CPU, same weights and eps: logits {err:.3e} of "
        f"max|ref| (tol {PHISEG_EVAL_OF_MAX}), {flips} argmax flips of {logits['cpu'][..., 0].numel()} pixels")
    check(err <= PHISEG_EVAL_OF_MAX, f"f32 eval logits: {err:.3e} of max|ref|")
    ref = image_metrics(logits["cpu"], y_all, y_all[0])
    metrics_agree(image_metrics(logits["cpu"].to(dev), y_all.to(dev), y_all[0].to(dev)), ref,
                  f"f32 {PHISEG_EXPERIMENT} metrics of the CPU's logits, card vs CPU")
    loss_err = max(abs(outs[dev][k].item() - outs["cpu"][k].item()) / abs(outs["cpu"][k].item())
                   for k in ("loss", "kl", "recon"))
    log(f"[eval] f32 eval_image card vs CPU: eval-mode loss/kl/recon rel {loss_err:.3e} (tol {PHISEG_LOSS_RTOL}); "
        f"GED {outs[dev]['ged'].item():.6f} vs {outs['cpu']['ged'].item():.6f}, NCC {outs[dev]['ncc'].item():.6f} "
        f"vs {outs['cpu']['ncc'].item():.6f} on each side's own logits")
    check(loss_err <= PHISEG_LOSS_RTOL, f"f32 eval-mode loss terms: rel diff {loss_err:.3e}")


def same_state(a, b, path: str = "state") -> None:
    """Two train states (``state_dict``s) are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        check(a.dtype == b.dtype and torch.equal(a, b), f"{path} changed")
    elif isinstance(a, dict):
        check(a.keys() == b.keys(), f"{path}: keys changed")
        for k in a:
            same_state(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            same_state(u, v, f"{path}[{i}]")
    else:
        check(a == b, f"{path}: {a} -> {b}")


def no_sync_enqueue(trainer, seconds=None):
    """Patches ``trainer.evaluate_images``, the per-image enqueue loop of
    ``validate`` and ``test``, so that a host sync inside it raises. With a
    list ``seconds``, appends each call's time from a fenced start to the
    end of its device work (the enqueue and what the fetch waits for)."""
    enqueue = trainer.evaluate_images

    def guarded(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = enqueue(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        return out

    return mock.patch.object(trainer, "evaluate_images", guarded)


def ncc_moves(got, want, y_all) -> torch.Tensor:
    """How far each image's variance-NCC may move when its U-Net logits
    (B, H, W, C) move from ``want`` to ``got`` (the samples all agree, so
    one sample gives the maps): NCC is the mean over the annotators of the
    correlation of the E_ss and E_sy maps, and by Cauchy-Schwarz a
    correlation moves by at most 2|da|/|a - mean a| for each map ``a`` that
    moves by ``da``."""
    def maps(logits):
        p = torch.softmax(logits.float(), -1)
        log_p = torch.log(p + 1e-8)
        e_ss = -(p * log_p).sum(-1)
        e_sy = -torch.gather(log_p[:, None].expand(-1, y_all.shape[1], -1, -1, -1), -1, y_all[..., None])[..., 0]
        return e_ss, e_sy  # (B, H, W), (B, A, H, W)

    def moves(a, b):
        return 2 * (a - b).flatten(-2).norm(dim=-1) / (b - b.mean((-2, -1), keepdim=True)).flatten(-2).norm(dim=-1)

    (g_ss, g_sy), (w_ss, w_sy) = maps(got), maps(want)
    return (moves(g_ss, w_ss)[:, None] + moves(g_sy, w_sy)).mean(1)


def unet_eval_agrees(conv_chain, trainer, data, n_val: int) -> int:
    """(d), the U-Net: the validation path's forwards (batch 1, full width,
    21 launches an image) with the kernel against the chain's plain version
    on the same trained weights, images and annotator picks. The logits by
    ``logits_agree``, with no argmax flip; then ``evaluate_images``' rows:
    Dice and GED of the same labels equal, NCC within what the logits'
    difference can move it (``ncc_moves``) plus NCC_ATOL (NaN where the
    plain path's is NaN), the loss terms within twice the logits' max|diff|
    (softmax CE moves by at most that) plus f32 rounding. Returns the
    kernel path's launches."""
    from unet_zoo_tpu_torch.training.trainer import EVAL_SCALARS

    _, images, labels = trainer._upload(data.validation, n_val)
    val_rng, annotators = trainer._eval_rng(), trainer._annotators()
    chosen = [int(val_rng.choice(annotators)) for _ in range(n_val)]
    model, n = trainer.state.model, HARNESS_VALIDATION_SAMPLES
    runs = {}
    for path in ("kernel", "plain"):
        torch.cuda.synchronize()
        before = conv_chain.launches
        with plain_chain() if path == "plain" else contextlib.nullcontext():
            was_training = model.training
            model.eval()
            with torch.inference_mode():
                logits = torch.cat([model.sample(images[i:i + 1], 1)[:, 0] for i in range(n_val)])
            model.train(was_training)
            rows, _ = trainer.evaluate_images(images, labels, chosen, n, n, salt=0)
        torch.cuda.synchronize()
        runs[path] = (logits.float().cpu(), rows.cpu(), conv_chain.launches - before)
    (got, got_rows, launched), (want, want_rows, plain_launched) = runs["kernel"], runs["plain"]
    expected = 2 * n_val * len(BLOCKS) * STAGES_PER_BLOCK
    check(launched == expected and plain_launched == 0,
          f"unet validation path: {launched} launches with the kernel (expected {expected}), {plain_launched} plain")
    logits_agree(got, want, f"unet validation path, {n_val} trained-model forwards at batch 1, kernel vs plain")
    err = (got - want).abs().max().item()
    flips = int((got.argmax(-1) != want.argmax(-1)).sum().item())
    check(flips == 0, f"unet validation path: {flips} argmax flips between the kernel and the plain chain")
    k = len(EVAL_SCALARS)
    col = {name: i for i, name in enumerate(EVAL_SCALARS)}
    ged_err = (got_rows[:, col["ged"]] - want_rows[:, col["ged"]]).abs().max().item()
    check(ged_err <= GED_RTOL * max(1.0, want_rows[:, col["ged"]].abs().max().item()), f"GED |diff| {ged_err}")
    g_ncc, w_ncc = got_rows[:, col["ncc"]], want_rows[:, col["ncc"]]
    check(torch.equal(g_ncc.isnan(), w_ncc.isnan()), f"NCC NaN pattern {g_ncc.tolist()} vs {w_ncc.tolist()}")
    finite = ~w_ncc.isnan()
    ncc_diff, ncc_tol = (g_ncc - w_ncc).abs()[finite], (ncc_moves(got, want, labels.cpu()) + NCC_ATOL)[finite]
    check(bool((ncc_diff <= ncc_tol).all()), f"NCC |diff| {ncc_diff.tolist()} > tol {ncc_tol.tolist()}")
    ncc_err = ncc_diff.max().item() if bool(finite.any()) else 0.0
    check(torch.equal(got_rows[:, k:], want_rows[:, k:]), f"Dice {got_rows[:, k:]} vs {want_rows[:, k:]}")
    terms = [col[t] for t in ("loss", "kl", "recon")]
    loss_err = (got_rows[:, terms] - want_rows[:, terms]).abs().max().item()
    loss_tol = 2 * err + 1e-6 * max(1.0, want_rows[:, terms].abs().max().item())
    check(loss_err <= loss_tol, f"loss terms |diff| {loss_err} > {loss_tol}")
    log(f"[harness] unet validation path, kernel vs plain chain on the same {n_val} images and picks: "
        f"{launched} launches (expected {expected}), 0 argmax flips, GED |diff| {ged_err:.3e}, NCC |diff| "
        f"{ncc_err:.3e} (each image's tol {', '.join(f'{t:.3e}' for t in ncc_tol.tolist())}; NaN in "
        f"{int(w_ncc.isnan().sum())} images on both), Dice equal, loss terms |diff| "
        f"{loss_err:.3e} (tol {loss_tol:.3e})")
    return launched


# conv-chain launches of each family: (a train step, an image validated:
# the U-Net's one forward; ProbUNet's sample, then its loss forward)
HARNESS_LAUNCHES = {"unet": (len(BLOCKS) * STAGES_PER_BLOCK,) * 2, "phiseg": (0, 0),
                    "prob_unet": (PROB_LAUNCHES, 2 * PROB_LAUNCHES)}


def harness(conv_chain, dev, card: str, log_root: str, names=("unet", PHISEG_EXPERIMENT),
            iterations: int = HARNESS_ITERATIONS, frequency: int = HARNESS_VALIDATION_FREQUENCY) -> dict:
    """(d): train for ``iterations`` with a validation every ``frequency``,
    validate and test on in-memory synthetic LIDC."""
    from unet_zoo_tpu_torch.data import LIDCData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    data = LIDCData(synthetic.lidc_splits(HARNESS_SPLITS, IMAGE, seed=0), seed=0)
    n_val, n_test = HARNESS_SPLITS[1], HARNESS_SPLITS[2]
    validations = iterations // frequency
    result = {}
    for name in names:
        cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16",
                                  validation_frequency=frequency,
                                  logging_frequency=frequency, num_validation_images=n_val,
                                  validation_samples=HARNESS_VALIDATION_SAMPLES)
        log_dir = os.path.join(log_root, name)
        trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
        unet = cfg.model == "unet"
        per_step, per_image = HARNESS_LAUNCHES[cfg.model]
        torch.cuda.synchronize()
        conv_chain.launches = 0
        t0 = time.perf_counter()
        aux = trainer.train(data, iterations=iterations)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        expected = iterations * per_step + validations * n_val * per_image
        check(conv_chain.launches == expected, f"{name}: train() launched {conv_chain.launches}, expected {expected}")
        check(trainer.state.step == iterations and math.isfinite(aux["loss"].item()),
              f"{name}: step {trainer.state.step}, loss {aux['loss'].item()}")
        with open(os.path.join(log_dir, "metrics_validation.jsonl")) as f:
            records = [json.loads(line) for line in f]
        check([r["step"] for r in records] == [frequency * (i + 1) for i in range(validations)],
              f"{name}: validation records {records}")
        # NCC is NaN where an image's E_ss is constant (the U-Net's samples
        # all agree, and a saturated output has a constant entropy); NaN is
        # never a best, as in the JAX package, so best_ncc needs a finite one
        files = ["validation_ckpt", "best_dice", "best_loss", "best_ged", "best_metrics.json",
                 "metrics_validation.jsonl", "metrics_train.jsonl"]
        files += ["best_ncc"] if any(math.isfinite(r["ncc"]) for r in records) else []
        missing = [f for f in files if not os.path.exists(os.path.join(log_dir, f))]
        check(not missing, f"{name}: missing {missing}")
        log(f"[harness] {name} bf16: train({iterations}) with a validation every "
            f"{frequency} ({n_val} images x {HARNESS_VALIDATION_SAMPLES} samples) in "
            f"{train_s:.2f} s, {conv_chain.launches} conv-chain launches (expected {expected}); all of {files} "
            f"written; last validation {json.dumps(records[-1])}")

        # one more validation: no host sync while it enqueues, the train state bit-identical after it
        before = copy.deepcopy(trainer.state.state_dict())
        torch.cuda.synchronize()
        conv_chain.launches = 0
        t0 = time.perf_counter()
        saves, save, eval_s = [], trainer.save_model, []
        with no_sync_enqueue(trainer, eval_s), \
                mock.patch.object(trainer, "save_model", lambda n: (saves.append(n), save(n))):
            agg = trainer.validate(data)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        eval_launches = conv_chain.launches
        expected = n_val * per_image
        check(eval_launches == expected, f"{name}: validate() launched {eval_launches}, expected {expected}")
        same_state(before, trainer.state.state_dict())
        del before
        ncc_ok = -1 <= agg["ncc"] <= 1 or (unet and math.isnan(agg["ncc"]))
        check(all(math.isfinite(agg[k]) for k in ("ged", "loss")) and ncc_ok and 0 <= agg["dice"] <= 1,
              f"{name}: validation {agg}")
        log(f"[harness] {name}: validate() issued its {n_val} images with no host sync and left the parameters, "
            f"running statistics, optimizer state, generator and step bit-identical; {eval_launches} conv-chain "
            f"launches (expected {expected}); dice {agg['dice']:.4f} ged {agg['ged']:.4f} ncc {agg['ncc']:.4f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_model("validation_ckpt")
        ckpt_s = time.perf_counter() - t0
        ckpt_mb = os.path.getsize(os.path.join(log_dir, "validation_ckpt")) / 2 ** 20
        log(f"[time] {name} bf16 validation, {n_val} images x {HARNESS_VALIDATION_SAMPLES} samples (and as many "
            f"loss repeats): the evaluation (evaluate_images, enqueue and device work) {eval_s[0]:.3f} s, "
            f"{eval_s[0] / n_val:.4f} s an image; the whole validate() with its checkpoints {val_s:.3f} s, "
            f"{val_s / n_val:.4f} s an image; one checkpoint ({ckpt_mb:.1f} MiB) takes {ckpt_s:.3f} s to write, "
            f"and this validation wrote {len(saves)} ({', '.join(saves)}) | card: {card}")
        if unet:
            unet_eval_agrees(conv_chain, trainer, data, n_val)

        runs = []
        for _ in range(2):
            with no_sync_enqueue(trainer):
                res = trainer.test(data, num_repeats=HARNESS_TEST_REPEATS, num_samples=HARNESS_TEST_SAMPLES,
                                   checkpoint="best_loss")
            with np.load(os.path.join(log_dir, "test_results.npz")) as f:
                runs.append({k: f[k] for k in f.files})
        shapes = {k: v.shape for k, v in runs[0].items()}
        check(shapes == {"ged": (HARNESS_TEST_REPEATS, n_test), "ncc": (HARNESS_TEST_REPEATS, n_test),
                         "dice": (HARNESS_TEST_REPEATS, n_test, cfg.n_classes)}, f"{name}: test_results {shapes}")
        check(all(np.array_equal(runs[0][k], runs[1][k], equal_nan=True) for k in runs[0]),
              f"{name}: two test sweeps differ")
        log(f"[harness] {name}: test({HARNESS_TEST_REPEATS} repeats, {HARNESS_TEST_SAMPLES} samples, best_loss) "
            f"twice, the same test_results.npz {shapes}: GED {res['ged'][0]:.4f}±{res['ged'][1]:.4f} NCC "
            f"{res['ncc'][0]:.4f}±{res['ncc'][1]:.4f} Dice {res['dice'][0]:.4f}±{res['dice'][1]:.4f} "
            f"({res['seconds']:.2f} s a sweep)")
        result[name] = {"eval_launches": eval_launches, "validation_eval_s_per_image": eval_s[0] / n_val,
                        "validation_with_checkpoints_s_per_image": val_s / n_val}
        del trainer
        torch.cuda.empty_cache()
    return result


def rev_module_parity(dev, card: str) -> dict:
    """(a): ``ReversibleChain`` against autograd of the same coupling chain at
    the full-width block shapes, in f32 (TF32 off) and bf16, each against the
    chain's float64 gradient."""
    from unet_zoo_tpu_torch.ops import reversible as rev

    def function(x, ps):
        return rev.ReversibleChain.apply(x, *ps)[0]

    def autograd(x, ps):
        return rev.coupling_chain(x, rev._blocks(ps))[0]

    def rel_l2(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    result = {}
    for shape in REV_BLOCK_SHAPES:
        c = shape[-1]
        seq = rev.ReversibleSequence(c, c, REV_DEPTH, device=dev, generator=torch.Generator().manual_seed(9)).train()
        gen = torch.Generator(device=dev).manual_seed(10)
        x, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        names = ["x"] + [n for n, _ in seq.named_parameters()]

        def grads(fn, dtype):
            xx = x.to(dtype).requires_grad_()
            ps = [p.detach().to(torch.float64 if dtype == torch.float64 else torch.float32).requires_grad_()
                  for p in seq.parameters()]
            y = fn(xx, ps)
            return y, torch.autograd.grad(y, [xx, *ps], g.to(dtype))

        (y, got), (y_ref, want) = grads(function, torch.float32), grads(autograd, torch.float32)
        exact = grads(autograd, torch.float64)[1]
        check(torch.equal(y, y_ref), f"{shape}: the Function's f32 output differs from the chain's")
        worst, worst_of_max, ratio = "", 0.0, 0.0
        for name, a, b, e in zip(names, got, want, exact):
            if not e.any():  # the coupling biases: an exact zero everywhere
                check(not a.any() and not b.any(), f"{shape} {name}: a non-zero gradient")
                continue
            fn_err, ag_err = rel_l2(a, e), rel_l2(b, e)
            check(fn_err <= REV_F32_VS_AUTOGRAD * ag_err + 1e-5,
                  f"{shape} f32 {name}: {fn_err:.3e} from float64, autograd's {ag_err:.3e}")
            if fn_err / (ag_err + 1e-12) > ratio:
                worst, ratio = name, fn_err / (ag_err + 1e-12)
            worst_of_max = max(worst_of_max, ((a - b).abs().max() / b.abs().max()).item())
        flat = [torch.cat([t.float().flatten() for t in ts]) for ts in (want,) + tuple(
            grads(fn, torch.bfloat16)[1] for fn in (function, autograd))]
        f32, fb, ab = flat
        fn_err, ag_err = rel_l2(fb, f32.double()), rel_l2(ab, f32.double())
        rel = rel_l2(fb, ab.double())
        check(fn_err <= REV_BF16_VS_AUTOGRAD * ag_err + 0.01, f"{shape} bf16: {fn_err:.3e} from f32 vs autograd's "
                                                               f"{ag_err:.3e}")
        log(f"[memory] ReversibleChain {shape} x{REV_DEPTH} blocks vs autograd of the same chain: f32 output "
            f"bit-identical, gradients as close to float64 as autograd's (worst ratio of relative L2 distances "
            f"{ratio:.3f} in {worst}, tol {REV_F32_VS_AUTOGRAD}; Function vs autograd max|diff| up to "
            f"{worst_of_max:.3e} of max|grad|); bf16 gradient {fn_err:.3e} from the f32 one (autograd's bf16: "
            f"{ag_err:.3e}; tol {REV_BF16_VS_AUTOGRAD}x + 0.01), {rel:.3e} relative L2 from autograd's bf16 "
            f"gradient | card: {card}")
        result[str(shape)] = {"f32_vs_autograd_ratio": ratio, "f32_max_diff_of_max": worst_of_max,
                              "bf16_from_f32": fn_err, "bf16_autograd_from_f32": ag_err,
                              "bf16_rel_l2_vs_autograd": rel}
    return result


def z_eps(cfg, batch: int, gen, dev):
    """The train step's z noise: ProbUNet's posterior (B, latent_dim), or
    PHiSeg's one N(0, 1) tensor a latent level."""
    if cfg.model == "prob_unet":
        return torch.randn((batch, cfg.latent_dim), generator=gen, device=dev)
    return [torch.randn((batch, IMAGE >> (lvl + 2), IMAGE >> (lvl + 2), cfg.zdim), generator=gen, device=dev)
            for lvl in range(cfg.latent_levels)]


def stats_fold_once(trainer, x, y, gen, dev) -> float:
    """One train step from given draws, against a no-grad train-mode forward
    of a copy of the model from the state before it, on the same augmented
    batch and z noise: that forward folds each batch statistic into the
    running ones once, so the step's running statistics must equal it (a
    second fold in the backward's re-run would move them by ~1% of a
    statistic). Every statistic must move. Returns max|diff| over the
    buffer's max|value|."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params

    cfg, model = trainer.cfg, trainer.state.model
    draws = sample_augment_params(gen, x.shape[0], (IMAGE, IMAGE), cfg.augmentation_options, dev)
    latent = cfg.model in ("phiseg", "prob_unet")
    eps = z_eps(cfg, x.shape[0], gen, dev) if latent else None
    before = copy.deepcopy(model)
    trainer.train_step(x, y, draws, eps)
    got, want = dict(model.named_buffers()), dict(before.named_buffers())
    still = [n for n, b in want.items() if torch.equal(got[n], b)]
    check(bool(got) and not still, f"{cfg.experiment_name}: running statistics that did not move: {still}")
    xa, ya = trainer.augment(x, y, draws)
    with torch.no_grad():
        before.train()
        before(xa, ya, post_eps=eps) if latent else before(xa)
    return max(((got[n] - b).abs().max() / b.abs().max()).item() for n, b in want.items())


def deterministic_resize():
    """Context in which the models' ``ops.resize_linear`` runs as two
    interpolation-matrix products (each matrix ``F.interpolate`` of an
    identity), whose backward is deterministic: ``F.interpolate``'s bilinear
    backward on the card adds with atomics, in an order that varies from run
    to run."""
    from unet_zoo_tpu_torch import ops

    def matrix(n_in, n_out, align_corners, like):
        eye = torch.eye(n_in, device=like.device)[:, None]
        w = torch.nn.functional.interpolate(eye, size=n_out, mode="linear", align_corners=align_corners)
        return w[:, 0].to(like.dtype)

    def resize_linear(x, out_size, align_corners):
        wh, ww = (matrix(x.shape[1 + i], out_size[i], align_corners, x) for i in range(2))
        return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)

    return mock.patch.object(ops, "resize_linear", resize_linear)


def remat_matches_plain(dev, log_dir: str) -> None:
    """(c): the remat U-Net step against the plain one from the same state
    and draws, with cuDNN deterministic and a deterministic resize on both
    sides: loss and every gradient bit-identical."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    base = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=REMAT_BATCH)
    xs, ys = train_batches(1, dev, REMAT_BATCH)
    draws = sample_augment_params(torch.Generator(device=dev).manual_seed(11), REMAT_BATCH, (IMAGE, IMAGE),
                                  base.augmentation_options, dev)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with deterministic_resize():
            for mode in ("plain", "remat"):
                tr = Trainer(dataclasses.replace(base, reversible_mode=mode), dev, seed=1, log_dir=log_dir)
                loss = tr.train_step(xs[0], ys[0], draws)["loss"]
                runs[mode] = (loss, {n: p.grad.clone() for n, p in tr.state.model.named_parameters()})
                del tr
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss_p, grads_p), (loss_r, grads_r) = runs["plain"], runs["remat"]
    check(torch.equal(loss_p, loss_r), f"remat loss {loss_r.item()} vs plain {loss_p.item()}")
    differ = [n for n in grads_p if not torch.equal(grads_p[n], grads_r[n])]
    check(not differ, f"remat gradients differ from plain in {differ}")
    log(f"[memory] remat U-Net step bs{REMAT_BATCH} bf16 vs the plain step from the same state and draws "
        f"(cuDNN deterministic, resize as matrix products on both sides): loss {loss_p.item():.6f} and all "
        f"{len(grads_p)} gradients bit-identical; the U-Net has no running statistics")


def zero_bias_gates(model, before: dict, cfg, label: str) -> dict:
    """The first step's gradients: every parameter has one; each bias that
    BatchNorm follows (a coupling function's ``_bias``, a conv bias beside a
    ``bn``) an exact zero, every other a non-zero one."""
    params = dict(model.named_parameters())
    free = [n for n in params if n.endswith("_bias")
            or (n.endswith("conv.bias") and f"{n[:-len('conv.bias')]}bn.weight" in params)]
    missing = [n for n, p in params.items() if p.grad is None]
    check(not missing, f"{label}: no gradient in {missing}")
    nonzero = [n for n in free if bool(params[n].grad.ne(0).any())]
    check(not nonzero, f"{label}: biases that BatchNorm follows with a non-zero gradient: {nonzero}")
    dead = [n for n in params if n not in free and not bool(params[n].grad.ne(0).any())]
    check(not dead, f"{label}: all-zero gradient in {dead}")
    log(f"[memory] {label} step 1: gradients in all {len(params)} parameters ({len(free)} BN-followed biases an "
        f"exact zero)")
    return {"zero_biases": len(free)}


def mode_slice(conv_chain, dev, card: str, log_dir: str, name: str, batch=None, mode=None, launches=None,
               gates=zero_bias_gates, time_steps: int = MODE_TIME_STEPS) -> dict:
    """Phase 8 (c) and (e), phase 9 (c) and (f): MODE_STEPS bf16 steps of
    one path from a fixed seed, at ``batch`` and in memory mode ``mode``
    (the registered ones by default): the first step's gradients held by
    ``gates(model, parameters before, cfg, label)``, no host sync in the
    others, ``launches`` conv-chain launches a step (where given), finite
    losses that fall, the running statistics folded once a step; then the
    step's times (``step_times`` over ``time_steps``)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16")
    if batch is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch)
    if mode is not None:
        cfg = dataclasses.replace(cfg, reversible_mode=mode)
    batch = cfg.batch_size
    label = f"{name} {cfg.effective_reversible_mode} bs{batch} bf16"
    xs, ys = train_batches(MODE_STEPS, dev, batch)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    model = trainer.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    conv_chain.launches = 0
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    first = conv_chain.launches
    check(launches is None or first == launches, f"{label}: step 1 launched the conv-chain kernel {first} times, "
                                                 f"expected {launches}")
    gated = gates(model, before, cfg, label)
    del before
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside a step raises
    for i in range(1, MODE_STEPS):
        losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = conv_chain.launches
    check(launches is None or launched == MODE_STEPS * launches, f"{label}: {launched} launches in {MODE_STEPS} steps")
    losses = torch.stack(losses).float().cpu()
    log(f"[memory] {label} losses: {' '.join(f'{v:.6g}' for v in losses.tolist())}")
    check(bool(torch.isfinite(losses).all()), f"{label}: non-finite loss {losses.tolist()}")
    tail = losses[-3:].mean().item()
    check(tail < losses[0].item(), f"{label}: loss did not fall: {losses.tolist()}")
    stats_err = None
    if list(model.buffers()):
        stats_err = stats_fold_once(trainer, xs[0], ys[0], torch.Generator(device=dev).manual_seed(12), dev)
        check(stats_err <= 1e-6, f"{label}: running statistics {stats_err:.3e} off one fold a step")
    log(f"[memory] {label}: {MODE_STEPS} steps with device augmentation, no host sync inside a step, "
        f"{first} conv-chain launches in step 1 and {launched} in all; running statistics "
        + (f"{stats_err:.3e} from one fold a step" if stats_err is not None else "none")
        + f"; loss {losses[0]:.4g} -> mean of the last 3 {tail:.4g}")

    t = step_times(trainer, xs[0], ys[0], time_steps)
    phases = t["phases_ms"]
    log(f"[time] {label} train step with device augmentation: {t['ms']:.3f} ms, {batch / t['ms'] * 1e3:.1f} "
        f"images/s; the host issues a step onto an idle device in {t['host_ms']:.3f} ms (min of {time_steps}, "
        f"median {t['host_median_ms']:.3f}); phases, ms/step: augmentation {phases[0]:.3f}, forward+loss "
        f"{phases[1]:.3f}, backward {phases[2]:.3f}, optimizer+plateau {phases[3]:.3f} | card: {card}")
    result = {"first_step_launches": first, "launches": launched, "images_s": batch / t["ms"] * 1e3,
              "losses": losses.tolist(), "stats_err": stats_err, **t, **gated}
    del trainer, model
    torch.cuda.empty_cache()
    return result


def rev_step_agrees(dev, card: str, log_dir: str) -> dict:
    """(c): the first bf16 ``phiseg_rev_7_5_12`` step at batch 12 against the
    f32 step from the same weights, batch, augmentation draws and z noise.
    The loss and the whole gradient agree within bf16's reach, and on each
    side the parameter change equals coupled-L2 Adam's first update written
    out from that side's own gradient: ``-lr * g / (|g| + eps)`` with
    ``g = grad + weight_decay * p`` (Adam's moments are ``g`` and ``g**2``
    after their bias correction). A falling loss alone cannot show that: the
    path's loss climbs thirty-fold before it falls."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    batch = 12
    cfg = dataclasses.replace(get_experiment(REV_EXPERIMENT), batch_size=batch)
    xs, ys = train_batches(1, dev, batch)
    gen = torch.Generator(device=dev).manual_seed(13)
    draws = sample_augment_params(gen, batch, (IMAGE, IMAGE), cfg.augmentation_options, dev)
    eps = z_eps(cfg, batch, gen, dev)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    runs = {}
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(dataclasses.replace(cfg, dtype=dtype), dev, seed=0, log_dir=log_dir)
        params = dict(trainer.state.model.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        loss = trainer.train_step(xs[0], ys[0], draws, eps)["loss"].float()
        grads = {n: p.grad.detach().clone() for n, p in params.items()}
        change = {n: p.detach() - before[n] for n, p in params.items()}
        adam_err = 0.0
        for n, g in grads.items():
            g = g + wd * before[n]
            adam_err = max(adam_err, (change[n] + lr * g / (g.abs() + 1e-8)).abs().max().item())
        check(adam_err <= ADAM_OF_LR * lr, f"{REV_EXPERIMENT} {dtype}: the first update is {adam_err:.3e} off "
                                           f"Adam's (tol {ADAM_OF_LR * lr:.1e})")
        runs[dtype] = (loss, grads, change, adam_err)
        del trainer, params
        torch.cuda.empty_cache()

    def rel_l2(a: dict, b: dict) -> float:
        fa, fb = (torch.cat([t.double().flatten() for t in d.values()]) for d in (a, b))
        return ((fa - fb).norm() / fb.norm()).item()

    (l32, g32, c32, e32), (l16, g16, c16, e16) = runs["float32"], runs["bfloat16"]
    loss_rel = abs(l16.item() - l32.item()) / abs(l32.item())
    grad_l2, change_l2 = rel_l2(g16, g32), rel_l2(c16, c32)
    check(math.isfinite(loss_rel) and grad_l2 <= REV_STEP_GRAD_L2,
          f"{REV_EXPERIMENT} bf16 step vs f32: loss {l16.item()} vs {l32.item()}, gradient {grad_l2:.3e} relative L2 "
          f"(tol {REV_STEP_GRAD_L2})")
    log(f"[memory] {REV_EXPERIMENT} bs{batch} first step, bf16 vs f32 from the same weights and draws: loss "
        f"{l16.item():.6g} vs {l32.item():.6g} ({loss_rel:.3e} relative), whole gradient {grad_l2:.3e} relative L2 "
        f"(tol {REV_STEP_GRAD_L2}), parameter change {change_l2:.3e} relative L2; each side's change off Adam's "
        f"first update by {e16:.3e} (bf16) and {e32:.3e} (f32), tol {ADAM_OF_LR * lr:.1e} | card: {card}")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_l2, "change_rel_l2": change_l2,
            "adam_err": {"bfloat16": e16, "float32": e32}}


def memory_modes(conv_chain, dev, card: str, log_dir: str) -> dict:
    """Phase 8: the remat and reversible memory modes."""
    import importlib.util

    t0 = time.perf_counter()
    parity = rev_module_parity(dev, card)
    phiseg_parity(dev, REV_EXPERIMENT, modes=(True,))
    per_step = 2 * len(BLOCKS) * STAGES_PER_BLOCK
    paths = {"phiseg_rev": mode_slice(conv_chain, dev, card, log_dir, REV_EXPERIMENT, 12, launches=0),
             "reversible_unet": mode_slice(conv_chain, dev, card, log_dir, "reversible_unet", 12, launches=0),
             "unet_remat": mode_slice(conv_chain, dev, card, log_dir, "unet", REMAT_BATCH, "remat",
                                      launches=per_step)}
    log(f"[memory] remat U-Net: {per_step} conv-chain launches a step (21 in the forward, 21 in the backward's "
        f"re-run); the reversible paths launch none (their coupling functions carry BatchNorm)")
    remat_matches_plain(dev, log_dir)
    rev_step = rev_step_agrees(dev, card, log_dir)

    spec = importlib.util.spec_from_file_location("torch_memory", os.path.join(REPO, "tools", "torch_memory.py"))
    torch_memory = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_memory)
    rows = torch_memory.memory_table(dev, card, log=log)
    for tf32 in (False, True):
        peak = {r["mode"]: r["peak_bytes"] for r in rows
                if r["experiment"] == "phiseg_7_5_12" and r["batch"] == 12 and r["tf32"] == tf32}
        check(peak["remat"] < peak["plain"] and peak["reversible"] < peak["plain"],
              f"PHiSeg f32 bs12 peak memory (TF32 {tf32}): {peak}")

    evaluation = eval_timing(conv_chain, dev, card, log_dir, REV_EXPERIMENT)
    log(f"[memory] phase 8 took {time.perf_counter() - t0:.1f} s")
    return {"parity": parity, "paths": paths, "rev_step": rev_step, "memory": rows, "eval100_ms": evaluation["ms"],
            "eval100_host_ms": evaluation["host_ms"]}


def prob_run(model, x, y, eps, train: bool):
    """One ProbUNet forward with the mask, the loss and its gradients:
    (outputs, aux, {parameter: grad})."""
    model.train(train)
    model.zero_grad(set_to_none=True)
    out = model(x, y, post_eps=eps)
    loss, aux = model.loss(out, y)
    loss.backward()
    return out, aux, {n: p.grad for n, p in model.named_parameters()}


def prob_parity(conv_chain, dev) -> dict:
    """(a): the float32 ``prob_unet`` at full width, the same weights and z
    noise on the card (its trunk on ``conv3x3_f32_fma``) and on the CPU (the
    plain chain), TF32 off: eval mode, every output and gradient (the
    gradient gate per tensor), then train mode, the outputs, loss terms,
    the whole gradient and the running statistics, at phase 6's gates."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    cfg = get_experiment(PROB_EXPERIMENT)
    models = {d: get_model(cfg.model, **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((PHISEG_PARITY_BATCH, IMAGE, IMAGE, 1), generator=gen)
    y = (torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4) > 0)[:, 0].long()
    eps = torch.randn((PHISEG_PARITY_BATCH, cfg.latent_dim), generator=gen)
    result = {}
    for train in (False, True):
        mode = "train" if train else "eval"
        models[dev].load_state_dict(models["cpu"].state_dict())  # the same running statistics
        runs = {"cpu": prob_run(models["cpu"], x, y, eps, train)}
        torch.cuda.synchronize()
        conv_chain.launches = 0
        runs[dev] = prob_run(models[dev], x.to(dev), y.to(dev), eps.to(dev), train)
        torch.cuda.synchronize()
        launched = conv_chain.launches
        check(launched == PROB_LAUNCHES, f"f32 {mode} forward on the card: {launched} conv-chain launches")
        (out_c, aux_c, g_c), (out_g, aux_g, g_g) = runs["cpu"], runs[dev]
        of_max = PHISEG_TRAIN_OF_MAX if train else PHISEG_EVAL_OF_MAX
        out_err = 0.0
        for key, ref in out_c.items():
            err = (out_g[key].detach().cpu() - ref.detach()).abs().max().item() / ref.detach().abs().max().item()
            out_err = max(out_err, err)
            check(err <= of_max, f"prob_unet f32 {mode} {key}: {err:.3e} of max|ref| > {of_max}")
        loss_err = max(abs(aux_g[k].item() - aux_c[k].item()) / abs(aux_c[k].item()) for k in ("loss", "kl", "recon"))
        check(loss_err <= PHISEG_LOSS_RTOL, f"prob_unet f32 {mode} loss terms: rel diff {loss_err:.3e}")
        zero = [n for n in ("last_conv.conv.weight", "last_conv.conv.bias") if g_c[n].any() or g_g[n].any()]
        check(not zero, f"prob_unet f32 {mode}: a non-zero last_conv gradient in {zero}")
        per_tensor, worst = max((((g_g[n].cpu() - g_c[n]).abs().max() / g_c[n].abs().max()).item(), n)
                                for n in g_c if g_c[n].any())
        tensor_l2, worst_l2 = max((((g_g[n].cpu() - g_c[n]).norm() / g_c[n].norm()).item(), n)
                                  for n in g_c if g_c[n].any())
        flat = {d: torch.cat([g[n].detach().cpu().flatten() for n in g_c]) for d, g in (("cpu", g_c), (dev, g_g))}
        l2 = ((flat[dev] - flat["cpu"]).norm() / flat["cpu"].norm()).item()
        check(l2 <= PHISEG_TRAIN_GRAD_L2, f"prob_unet f32 {mode} gradient: rel L2 {l2:.3e}")
        tol = f"tol L2 {PHISEG_TRAIN_GRAD_L2}"
        if not train:
            check(tensor_l2 <= PROB_EVAL_TENSOR_L2, f"prob_unet f32 eval gradient {worst_l2}: rel L2 {tensor_l2:.3e}")
            tol += f", each tensor's {PROB_EVAL_TENSOR_L2}"
        else:
            gpu_buffers = dict(models[dev].named_buffers())
            stats_err = max(((gpu_buffers[n].cpu() - b).abs().max() / b.abs().max()).item()
                            for n, b in models["cpu"].named_buffers())
            check(stats_err <= PHISEG_STATS_RTOL, f"prob_unet running statistics: rel diff {stats_err:.3e}")
            tol += f"; running statistics rel {stats_err:.3e}, tol {PHISEG_STATS_RTOL}"
        log(f"[prob_unet] f32 {mode} mode, card ({launched} launches of conv3x3_f32_fma) vs CPU, batch "
            f"{PHISEG_PARITY_BATCH}, {len(g_c)} gradients: outputs {out_err:.3e} of max|ref| (tol {of_max}), "
            f"loss/kl/recon rel {loss_err:.3e} (tol {PHISEG_LOSS_RTOL}), last_conv's gradient an exact zero on "
            f"both, whole gradient rel L2 {l2:.3e} ({tol}); worst tensor by max {worst} {per_tensor:.3e} of its "
            f"max|g|, by L2 {worst_l2} {tensor_l2:.3e}")
        result[mode] = {"outputs_of_max": out_err, "loss_rel": loss_err, "grad_rel_l2": l2,
                        "worst_grad_of_max": per_tensor, "worst_tensor_rel_l2": tensor_l2}
    del models
    return result


def f32_block_row(conv_chain, x, ks, bs, block: str, card: str) -> dict:
    """Times of one float32 chain at its shape: the kernel, the plain
    version and cuDNN conv+bias+ReLU (TF32 off), CUDA events, the min of 2
    rounds of F32_BLOCK_ITERS, beside its bound at the f32 CUDA-core peak."""
    batch, size, _, ci = x.shape
    chans = [(k.shape[1], k.shape[0]) for k in ks]
    packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
    k_ms = min(cuda_ms(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), F32_BLOCK_ITERS)
               for _ in range(2))
    p_ms = min(cuda_ms(lambda: conv_chain.fused_conv_chain_reference(x, ks, bs), F32_BLOCK_ITERS) for _ in range(2))
    c_ms = min(cuda_ms(lambda: cudnn_chain(x, ks, bs), F32_BLOCK_ITERS) for _ in range(2))
    b_ms, b_by = bound(*chain_cost(batch, size, chans, itemsize=4), PEAK_F32_FLOPS)
    log(f"[time] f32 {block} ({batch}, {size}, {size}, {ci})->{chans[-1][1]} x3: conv3x3_f32_fma {k_ms:.3f} ms "
        f"({b_ms / k_ms:.1%} of its {b_ms:.3f} ms bound by {b_by} at 67 TFLOP/s f32), plain {p_ms:.3f} ms, cuDNN "
        f"f32 conv+bias+ReLU (TF32 off) {c_ms:.3f} ms | card: {card}")
    return {"block": block, "batch": batch, "ms": k_ms, "plain_ms": p_ms, "library_ms": c_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def prob_blocks(conv_chain, dev, card: str) -> dict:
    """(b): the 13 trunk block shapes at each batch the ProbUNet path gives
    the kernel (PROB_CHECK_BATCHES: the launch plan's items, and at 128x128
    its tile height, depend on the batch), kernel against plain in float32
    and bf16 (each bf16 stage's plan logged), and the float32 kernel's time
    per block at batch 12 at those shapes and at the U-Net's 7."""
    gen = torch.Generator().manual_seed(14)
    rows = {"prob_unet": [], "unet": []}
    errs = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            for block, size, ci, co in PROB_BLOCKS:
                chans = [(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1)
                ks, bs = chain_weights(chans, gen, dev)
                for batch in PROB_CHECK_BATCHES:
                    x = torch.randn((batch, size, size, ci), generator=gen).to(dev, dtype)
                    errs.append(compare(conv_chain, x, ks, bs, f"{name} prob_unet {block} ({batch}, {size}, {size}, "
                                                               f"{ci})->{co}"))
                    if dtype == torch.bfloat16:
                        for c_in, c_out in chans:
                            p = conv_chain.launch_plan((batch, size, size, c_in), c_out)
                            log(f"[plan]   {block} bs{batch} {c_in}->{c_out} at {size}x{size}: chunk {p.chunk}, "
                                f"{p.block_n} channels a block, {p.tile_h}x16 tile, {p.items} items, {p.loader} "
                                f"loader, weights {'resident' if p.resident else 'ring'}")
                    if dtype == torch.float32 and batch == PROB_BATCH:
                        rows["prob_unet"].append(f32_block_row(conv_chain, x, ks, bs, f"prob_unet {block}", card))
                    del x
        for block, size, ci, co in BLOCKS:
            chans = [(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1)
            x = torch.randn((PROB_BATCH, size, size, ci), generator=gen).to(dev)
            ks, bs = chain_weights(chans, gen, dev)
            rows["unet"].append(f32_block_row(conv_chain, x, ks, bs, f"unet {block}", card))
            del x
    for net, rs in rows.items():
        k, c, b = (sum(r[key] for r in rs) for key in ("ms", "library_ms", "bound_ms"))
        log(f"[time] f32 {net} trunk, {len(rs)} blocks at bs{PROB_BATCH}: conv3x3_f32_fma {k:.3f} ms, cuDNN f32 "
            f"{c:.3f} ms, bound {b:.3f} ms ({b / k:.1%}) | card: {card}")
    log(f"[kernel] prob_unet trunk: {len(errs)} block checks ({len(PROB_BLOCKS)} blocks x batches "
        f"{PROB_CHECK_BATCHES} x f32, bf16) all within tolerance")
    return {"rows": rows, "max_abs_err": max(errs)}


def prob_grad_gates(model, before: dict, cfg, label: str) -> dict:
    """The first step's gradients and update: every parameter has a
    gradient; each bias that BatchNorm follows (a conv bias beside a ``bn``,
    a coupling function's ``_bias``) has exactly the regularizer's term (the
    encoders' and fcomb's) or an exact zero (the trunk's); ``last_conv``'s
    gradient is an exact zero and its change is coupled-L2 Adam's first
    update of the decay alone, -lr * g / (|g| + 1e-8) with g = wd * p; every
    other gradient is non-zero."""
    from unet_zoo_tpu_torch.models.prob_unet import NORM_EPS, REG_WEIGHT

    lr, wd = cfg.learning_rate, cfg.weight_decay
    params = dict(model.named_parameters())
    missing = [n for n, p in params.items() if p.grad is None]
    check(not missing, f"{label}: no gradient in {missing}")
    reg = {n for n, _ in model.regularized_parameters()}
    cut = [n for n in params if re.search(r"block\d+_[fg]_bias$", n)
           or (n.endswith("conv.bias") and f"{n[:-len('conv.bias')]}bn.weight" in params)]
    term_err, zeros = 0.0, 0
    for n in cut:
        if n in reg:
            b = before[n]
            want = REG_WEIGHT * b / torch.sqrt(b.square().sum() + NORM_EPS)
            err = ((params[n].grad - want).abs().max() / want.abs().max()).item()
            term_err = max(term_err, err)
            check(err <= REG_GRAD_RTOL, f"{label}: {n}'s gradient {err:.3e} off the regularizer's term")
        else:
            check(not params[n].grad.any(), f"{label}: a non-zero gradient in {n}, which BatchNorm follows")
            zeros += 1
    adam_err = 0.0
    for n in ("last_conv.conv.weight", "last_conv.conv.bias"):
        check(not params[n].grad.any(), f"{label}: a non-zero gradient in {n}")
        g = wd * before[n]
        adam_err = max(adam_err, (params[n].detach() - before[n] + lr * g / (g.abs() + 1e-8)).abs().max().item())
    check(adam_err <= ADAM_OF_LR * lr, f"{label}: last_conv moved {adam_err:.3e} off Adam's decay-only update")
    dead = [n for n in params if n not in cut and not n.startswith("last_conv.") and not params[n].grad.any()]
    check(not dead, f"{label}: all-zero gradient in {dead}")
    log(f"[prob_unet] {label} step 1: gradients in all {len(params)} parameters; {len(cut) - zeros} BN-followed "
        f"biases of the encoders and fcomb carry the regularizer's term alone ({term_err:.3e} of its max off, tol "
        f"{REG_GRAD_RTOL}), {zeros} of the trunk an exact zero; last_conv's gradient an exact zero and its change "
        f"{adam_err:.3e} off Adam's decay-only update (tol {ADAM_OF_LR * lr:.1e})")
    return {"reg_term_err": term_err, "last_conv_adam_err": adam_err, "regularized_biases": len(cut) - zeros}


def prob_f32_step(conv_chain, dev, card: str, log_dir: str) -> dict:
    """(d): the registered float32 ``prob_unet`` step at batch 12: 39
    launches of ``conv3x3_f32_fma``, and its ms beside the same step with
    every trunk block on cuDNN f32 (the chain's plain version in place of
    the kernel's wrapper, ``plain_chain``; TF32 off), in turns."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment(PROB_EXPERIMENT)
    check(cfg.dtype == "float32", f"{PROB_EXPERIMENT} is registered in {cfg.dtype}")
    xs, ys = train_batches(1, dev, cfg.batch_size)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    check(trainer.chain_route == "conv3x3_f32_fma", f"f32 chains route to {trainer.chain_route}")
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    conv_chain.launches = 0
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    launched = conv_chain.launches
    check(launched == PROB_LAUNCHES, f"f32 {PROB_EXPERIMENT} step: {launched} launches of conv3x3_f32_fma")
    ms = {"kernel": math.inf, "cudnn": math.inf}
    for route in ("kernel", "cudnn", "cudnn", "kernel"):
        with plain_chain() if route == "cudnn" else contextlib.nullcontext():
            ms[route] = min(ms[route], cuda_ms(lambda: trainer.train_step(xs[0], ys[0]), MODE_TIME_STEPS))
    check(conv_chain.launches == launched + 2 * (MODE_TIME_STEPS + 1) * PROB_LAUNCHES,
          f"f32 timing: {conv_chain.launches - launched} launches, expected the kernel's rounds only")
    log(f"[time] {PROB_EXPERIMENT} f32 train step bs{cfg.batch_size} as registered ({launched} launches of "
        f"conv3x3_f32_fma a step): {ms['kernel']:.3f} ms; the same step with the trunk on cuDNN f32, TF32 off: "
        f"{ms['cudnn']:.3f} ms (min of 2 rounds of {MODE_TIME_STEPS} each, in turns) | card: {card}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launched, "ms": ms["kernel"], "cudnn_ms": ms["cudnn"]}


def prob_unet_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 9: the Probabilistic U-Net, plain and reversible."""
    t0 = time.perf_counter()
    parity = prob_parity(conv_chain, dev)
    blocks = prob_blocks(conv_chain, dev, card)
    plain = mode_slice(conv_chain, dev, card, log_root, PROB_EXPERIMENT, launches=PROB_LAUNCHES,
                       gates=prob_grad_gates, time_steps=TIME_STEPS)
    f32 = prob_f32_step(conv_chain, dev, card, log_root)
    evaluation = eval_timing(conv_chain, dev, card, log_root, PROB_EXPERIMENT, launches=2 * PROB_LAUNCHES)
    rev = mode_slice(conv_chain, dev, card, log_root, PROB_REV_EXPERIMENT, launches=0, gates=prob_grad_gates)
    # untrained, the reversible trunk's he_normal coupling blocks grow their
    # input ~1e10-fold on BatchNorm's initial running statistics (eval
    # mode), so sigma overflows and the eval-mode loss is NaN, as the JAX
    # model's is (its features reach 1.3e10 at init, float32 on a CPU), and
    # the saturated samples make NCC's entropy map constant, so NaN
    rev_eval = eval_timing(conv_chain, dev, card, log_root, PROB_REV_EXPERIMENT, finite=False)
    harnessed = harness(conv_chain, dev, card, log_root, names=(PROB_EXPERIMENT,), iterations=PROB_HARNESS_ITERATIONS,
                        frequency=PROB_HARNESS_ITERATIONS)[PROB_EXPERIMENT]
    log(f"[prob_unet] phase 9 took {time.perf_counter() - t0:.1f} s")
    return {"parity": parity, "blocks": blocks, "plain": plain, "f32": f32, "eval": evaluation, "rev": rev,
            "rev_eval": rev_eval, "harness": harnessed}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain
    from unet_zoo_tpu_torch.ops.conv import chain_route
    from unet_zoo_tpu_torch.models.registry import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # 1. environment and build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | card: {card}")
    log(f"[env] kernel build+load {build_s:.2f} s -> {os.path.relpath(_build.library_path(), REPO)}")
    log(f"[env] host: {os.cpu_count()} CPUs, load average {os.getloadavg()[0]:.2f} over the last minute")
    build_log = _build.library_path().with_suffix(".log").read_text()
    ptxas_report(build_log)
    sass = sass_check(_build.library_path(), build_log)

    # 2. kernel vs plain version on the card
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for shape, chans in TEST_SHAPES:
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            ks, bs = chain_weights(chans, gen, dev, scale=0.2)
            compare(conv_chain, x, ks, bs, f"{name} test {shape} {chans}")
        for shape, chans in EDGE_SHAPES:
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            ks, bs = chain_weights(chans, gen, dev)
            compare(conv_chain, x, ks, bs, f"{name} edge {shape} {chans}")
            if dtype == torch.bfloat16:
                for ci, co in chans:
                    p = conv_chain.launch_plan((*shape[:3], ci), co)
                    log(f"[plan]   {ci}->{co}: chunk {p.chunk}, {p.block_n} channels a block, {p.tile_h}x16 "
                        f"tile, {p.items} items, {p.loader} loader, weights {'resident' if p.resident else 'ring'}")
        x = torch.ones((1, 12, 12, 3), device=dev, dtype=dtype)
        ks = [torch.full((4, 3, 3, 3), 0.1, device=dev), torch.full((4, 4, 3, 3), 0.1, device=dev)]
        bs = [torch.zeros(4, device=dev), torch.zeros(4, device=dev)]
        compare(conv_chain, x, ks, bs, f"{name} zero-border (1, 12, 12, 3)")
        for block, size, ci, co in BLOCKS:
            x = torch.randn((8, size, size, ci), generator=gen).to(dev, dtype)
            ks, bs = chain_weights([(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1), gen, dev)
            compare(conv_chain, x, ks, bs, f"{name} {block} (8, {size}, {size}, {ci})->{co}")

    # 3. the slice: full-width U-Net forward, bf16, batch 512, through the kernel
    model = get_model("unet", num_classes=2, num_filters=FILTERS, dtype=torch.bfloat16,
                      device=dev, generator=torch.Generator().manual_seed(0)).eval()
    cuda_gen = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn((BATCH, IMAGE, IMAGE, 1), generator=cuda_gen, device=dev)
          for _ in range(FORWARD_BATCHES)]
    expected = FORWARD_BATCHES * len(BLOCKS) * STAGES_PER_BLOCK
    torch.cuda.synchronize()
    conv_chain.launches = 0
    with torch.inference_mode():
        outs = [model(x) for x in xs]
    torch.cuda.synchronize()
    launched = conv_chain.launches
    log(f"[slice] {FORWARD_BATCHES} forwards of ({BATCH}, {IMAGE}, {IMAGE}, 1) bf16: "
        f"{launched} conv-chain kernel launches (expected {expected}: 7 blocks x 3 stages each)")
    check(launched == expected, f"kernel launched {launched} times, expected {expected}")
    for logits in outs:
        check(logits.shape == (BATCH, IMAGE, IMAGE, 2) and logits.dtype == torch.bfloat16,
              f"logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        seg = logits.argmax(-1)
        check(seg.shape == (BATCH, IMAGE, IMAGE), f"segmentation shape {tuple(seg.shape)}")
    log(f"[slice] logits finite, segmentation {tuple(seg.shape)}, "
        f"class-1 share {(seg == 1).float().mean().item():.4f}")
    # the whole main-path output against the same model on the plain path
    with torch.inference_mode():
        for i, (x, logits) in enumerate(zip(xs, outs)):
            logits_agree(logits, plain_path(model, x), f"bf16 forward {i} bs{BATCH}, kernel vs plain path")
    torch.cuda.synchronize()
    check(conv_chain.launches == launched, "the plain path launched the kernel")
    main_logits = outs[0][:2].float().cpu()
    del outs

    # the same weights in f32 on the card (kernel) and on the CPU (plain path)
    x2 = torch.randn((2, IMAGE, IMAGE, 1), generator=torch.Generator().manual_seed(2))
    kw = dict(num_classes=2, num_filters=FILTERS, dtype=torch.float32)
    m_gpu = get_model("unet", device=dev, generator=torch.Generator().manual_seed(0), **kw).eval()
    m_cpu = get_model("unet", device="cpu", generator=torch.Generator().manual_seed(0), **kw).eval()
    f32_launches = conv_chain.launches
    with torch.inference_mode():
        got = m_gpu(x2.to(dev)).cpu()
        want = m_cpu(x2)
    f32_launches = conv_chain.launches - f32_launches
    check(f32_launches == len(BLOCKS) * STAGES_PER_BLOCK, f"f32 forward: {f32_launches} conv-chain launches")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[slice] f32 batch-2 forward, card ({f32_launches} launches of {chain_route(torch.float32, dev)}) vs CPU "
        f"plain: max|diff| {err:.3e}  "
        f"max|ref| {scale:.3e}  tol {F32_RTOL * scale:.3e}")
    check(err <= F32_RTOL * scale, f"f32 forward: max|diff| {err} > {F32_RTOL * scale}")
    # the main path's bf16 logits of its first 2 images against the f32 CPU model
    with torch.inference_mode():
        logits_agree(main_logits, m_cpu(xs[0][:2].cpu()), "bf16 main path vs f32 CPU plain, 2 images")

    # 4. each block at bs512 and bs64 on the model's weights: kernel vs plain,
    # then times (CUDA events, after warm-up), beside the card's name and power limit
    with torch.inference_mode():
        fwd_ms = min(cuda_ms(lambda: model(xs[0]), 5) for _ in range(2))
    log(f"[time] U-Net forward bs{BATCH} {IMAGE}x{IMAGE} bf16: {fwd_ms:.3f} ms/batch, "
        f"{BATCH / fwd_ms * 1e3:.1f} images/s (mma.sync kernel: {MMA_SYNC_FORWARD_IMAGES_S[0]}-"
        f"{MMA_SYNC_FORWARD_IMAGES_S[1]} on an NVIDIA H100 80GB HBM3 at 700 W) | card: {card}")
    blocks = {batch: time_blocks(conv_chain, model, batch, cuda_gen, dev, card) for batch in (BATCH, TRAIN_BATCH)}
    host_launch_us = launch_host_us(conv_chain, model, dev)
    log(f"[time] host time to issue one bf16 kernel launch (plan, two tensor maps, launch), min of 5 rounds "
        f"of 21 stages: {host_launch_us:.1f} us | card: {card}")
    del model, xs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_logs_") as log_root:
        # 5. the train slice
        backward_err = function_grads_agree(conv_chain, dev, gen)
        train = train_slice(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 6. PHiSeg: f32 parity with the CPU, the bf16 train step, times
        t0 = time.perf_counter()
        phiseg_parity(dev)
        phiseg_slice(conv_chain, dev, card, log_root)
        log(f"[phiseg] phase 6 took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        # 7. evaluation and the harness
        t0 = time.perf_counter()
        metrics_parity(dev)
        evaluation = eval_timing(conv_chain, dev, card, log_root)
        eval_parity(dev, log_root)
        harnessed = harness(conv_chain, dev, card, log_root)
        log(f"[eval] phase 7 took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        # 8. the remat and reversible memory modes
        modes = memory_modes(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 9. the Probabilistic U-Net
        prob = prob_unet_phase(conv_chain, dev, card, log_root)

    main = blocks[BATCH]
    log(json.dumps({"kernels": [{
        "name": "fused_conv_chain",
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/csrc/conv_chain.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/conv_chain.py:132",
        "launches": launched,
        "max_abs_err": max(r["max_abs_err"] for rows in blocks.values() for r in rows),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main) else "bytes",
        "library_ms": sum(r["library_ms"] for r in main),
        "blocks": blocks,
        "sass": sass,
        "host_launch_us": host_launch_us,
        "train_launches": train["launches"],
        "backward_f32_max_err_of_max_grad": backward_err,
        "train_step_ms": train["ms"],
        "train_step_plain_ms": train["plain_ms"],
        "train_step_host_ms": train["host_ms"],
        "train_step_plain_host_ms": train["plain_host_ms"],
        "eval_launches": harnessed["unet"]["eval_launches"],
        "validation_eval_s_per_image": {k: v["validation_eval_s_per_image"] for k, v in harnessed.items()},
        "validation_with_checkpoints_s_per_image": {
            k: v["validation_with_checkpoints_s_per_image"] for k, v in harnessed.items()},
        "phiseg_eval100_ms": evaluation["ms"],
        "phiseg_eval100_host_ms": evaluation["host_ms"],
        "remat_train_launches": modes["paths"]["unet_remat"]["first_step_launches"],
        "f32_conv_seq_route": chain_route(torch.float32, dev),
        "memory_mode_steps": {k: {f: v[f] for f in ("launches", "ms", "images_s", "host_ms", "stats_err")}
                              for k, v in modes["paths"].items()},
        "reversible_chain_parity": modes["parity"],
        "phiseg_rev_bf16_step_vs_f32": modes["rev_step"],
        "memory_table": [{k: r[k] for k in ("experiment", "batch", "mode", "tf32", "peak_bytes", "state_bytes",
                                            "saving_vs_plain")} for r in modes["memory"]],
        "phiseg_rev_eval100_ms": modes["eval100_ms"],
        "phiseg_rev_eval100_host_ms": modes["eval100_host_ms"],
        "prob_unet_train_launches": prob["plain"]["first_step_launches"],
        "prob_unet_step_ms": prob["plain"]["ms"],
        "prob_unet_host_ms": prob["plain"]["host_ms"],
        "prob_unet_step_phases_ms": prob["plain"]["phases_ms"],
        "prob_unet_f32_launches": prob["f32"]["launches"],
        "prob_unet_f32_step_ms": prob["f32"]["ms"],
        "prob_unet_f32_step_cudnn_ms": prob["f32"]["cudnn_ms"],
        "prob_unet_eval100_ms": prob["eval"]["ms"],
        "prob_unet_eval100_host_ms": prob["eval"]["host_ms"],
        "prob_unet_eval100_launches": prob["eval"]["launches"],
        "prob_unet_rev_step_ms": prob["rev"]["ms"],
        "prob_unet_rev_host_ms": prob["rev"]["host_ms"],
        "prob_unet_rev_eval100_ms": prob["rev_eval"]["ms"],
        "prob_unet_parity": prob["parity"],
        "prob_unet_block_max_abs_err": prob["blocks"]["max_abs_err"],
        "prob_unet_validation_eval_s_per_image": prob["harness"]["validation_eval_s_per_image"],
        "f32_blocks_bs12": prob["blocks"]["rows"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
