#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``unet_zoo_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one NVIDIA GPU and nvcc

Phases, each printing its own lines:

1. environment: torch and CUDA versions, the card's name and power limit,
   the kernel build time, ptxas's registers, spills and static shared
   memory per kernel (no wgmma serialized, no spill in the f32 kernel), and
   a check of the kernels' machine code (``cuobjdump -sass``): every bf16
   and f32 instantiation issues wgmma (``HGMMA``) and TMA loads
   (``UTMALDG``) and no ``mma.sync`` (``HMMA``);
2. every hand-written kernel against its plain PyTorch version on the card,
   at the kernel tests' shapes, edge shapes (one full and one partial K
   chunk, 192 output channels in one block, C_in = 1 on the plain loader,
   images that are no multiple of the tile, batch 1) and each U-Net block
   shape (batch 8), in float32 and bfloat16, with each stage's launch
   plan; in float32 also against the kernel's own 3xTF32 arithmetic in
   plain PyTorch (F32_3XTF32_RTOL), and at F32_EDGE_SHAPES (1x1, 2x2 and
   4x4 images folded several to a tile, C_in 1, 4, 9 and 384);
3. the slice: the full-width U-Net forward (filters 32/64/128/192, 2 classes,
   batch 512, 128x128x1, bf16) under inference mode, with the kernel launch
   count checked; those logits against the same model with every block on
   the chain's plain version, on the card; a batch-2 float32 forward on the
   card (21 launches of the float32 kernel, ``conv3x3_f32_3xtf32_wgmma``) against the
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
   block shapes at batches 1, 12 and 16, kernel against plain in float32
   and bf16 with each stage's plan, REPEATS relaunches of each float32
   block at batch 12 bit for bit against the first, and the float32
   kernel's time per block there and at the U-Net's 7 blocks (the device's
   time, the host's issue taken out, beside the event time and the host's
   issue time), beside cuDNN f32 (TF32 off) and two bounds: at the f32
   CUDA-core peak (67 TFLOP/s) and at the 3xTF32 rate (494.7 / 3); (c)
   PROB_STEPS bf16 steps at batch 12 with
   device augmentation: 39 launches a step, no host sync, a finite loss,
   ``last_conv``'s gradient an exact zero and its change Adam's decay-only
   update written out, each BN-followed bias of the encoders and fcomb
   carrying the regularizer's term alone (REG_GRAD_RTOL), then ms a step,
   images/s, host issue ms and the phases; (d) the registered float32 step
   (39 launches of ``conv3x3_f32_3xtf32_wgmma``) and the float32 ``unet``
   step at batch 12 (21), each beside the same step with the trunk on cuDNN
   f32, with the host's issue time; (e) ``eval_image`` of one image with 100 samples (78
   launches); (f) PROB_STEPS bf16 steps of ``prob_unet_reversible`` (no
   launch) with its evaluation; (g) ``train``/``validate``/``test`` on the
   synthetic LIDC data of phase 7;
10. PHiSeg3D and the BraTS path (``phiseg_brats``: filters 32/64/128, 2
   latent levels, 128^3x4, 3 one-hot WT/TC/ET classes, reversible with one
   coupling block a sequence), which launches no hand-written kernel (every
   sequence carries BatchNorm or is reversible; a BN-free 3D sequence raises
   on every device): (a) the architecture at BRATS_PARITY_SIZE, batch 1, float32
   with TF32 off, plain and reversible, the same weights and z noise on the
   card and the CPU, eval and train mode, at phase 9 (a)'s gates; (b) the
   registered step (float32, reversible, 128^3, batch 1, 3D augmentation with
   the elastic field) for BRATS_STEPS steps on synthetic arrays from a seed:
   a gradient in every parameter (an exact zero in each bias that BatchNorm
   follows), no host sync inside a step, running statistics that move, a
   finite loss; then ms a step (events), the host's issue time, the phases
   and the peak MiB above what the card held before that step's trainer was
   built, and the same for the plain mode and for bf16; (c) the
   evaluation on BRATS_VAL_VOLUMES volumes: ``sample(x, 16)`` whole and in
   chunks of ``trainer.VOLUME_SAMPLE_CHUNK`` (ms, peak MiB), ``validate``
   (``validate_brats``, 16 samples, s a volume and the peak MiB, its
   checkpoints), ``test`` (``test_brats``, 1 repeat, the npz schema) and
   ``export_predictions``, whose ``.nii.gz`` files read back through the
   port's ``load_nii`` in the original geometry with labels in {0, 1, 2, 4},
   and HD95's host time for one region at 128^3;
11. the UZH prostate path (``phiseg_uzh_7_5_512``: PHiSeg 2D at filters
   32/64/128/192/192/192/192, 5 latent levels, 3 classes, 6 annotators,
   512x512, batch 12), which launches no hand-written kernel (every
   sequence carries BatchNorm or is reversible): (a) the registered
   architecture at 192x192 (``phiseg_uzh_7_5_192`` and
   ``phiseg_uzh_rev_7_5_192``), batch 2, float32 with TF32 off, the same
   weights and z noise on the card and the CPU, eval and train mode, at
   phase 6's gates; (b) ``UZHProstateData`` over ``synthetic.uzh_arrays`` at
   512x512 (the host ms of ``next_batch(12)`` as ``from_config`` builds the
   providers and with the registry's ``resize_to``, whose zoom at factor 1
   must leave the batch as it was), then UZH_STEPS registered steps (f32,
   plain, the experiment's 3-label device augmentation): a gradient in every
   parameter (an exact zero in each bias that BatchNorm follows), no host
   sync inside a step, running statistics that move, a finite loss, 0
   conv-chain launches, the peak above what the card held before the
   trainer; then ms a step (events), the host's issue ms, the phases and
   the peak of the plain, remat and reversible (``phiseg_uzh_rev_7_5_512``)
   f32 steps with cuDNN's TF32 off and on, and the bf16 step: (c) whether
   batch 12 fits the card in each mode (an out-of-memory step fails the
   phase); (d) ``sample(x, 16)`` at batch 1 (ms, peak), one evaluation
   window's upload peak beside the whole split's, ``validate`` over "all"
   UZH_SPLITS[1] validation images (more than ``EVAL_IMAGE_WINDOW``; 16
   samples; no host sync while a window is enqueued; s an image with and
   without its checkpoint writes, peak; finite GED, NCC in [-1, 1], Dice in
   [0, 1]) and ``test`` (1 repeat, ``dice`` (1, N, 3)); (e) ``UZHMatData``
   over a ``scipy.io.savemat`` file of 160 slices at 192x192 (the 10/100/50
   split, the batches, one train step at batch 2);
12. data parallelism (``unet_zoo_tpu_torch.parallel``, ``Trainer(mesh=)``):
   (a) a one-process NCCL group through ``init_distributed``/``make_mesh``:
   the bf16 ``unet`` step at bs64 and ``phiseg_7_5_12`` at bs12 with device
   augmentation, DP_STEPS steps from seed 0, each bit-identical to the plain
   step, in which the model draws its own z noise (``own_draws_step``; cuDNN
   deterministic, the resize as matrix products on both sides), 21
   conv-chain launches a U-Net step and none in PHiSeg, no host sync inside
   a step after the first, ms a step beside the plain step's;
   (b) DP_RANKS processes on the one card over gloo (NCCL takes one process
   a card; ``chip_smoke.py --dp-worker``), started together with a time
   limit: ``phiseg_7_5_12`` at full width as registered (f32, TF32 off),
   global bs12, and the f32 ``unet`` at global bs64, DP_RANK_STEPS steps
   with augmentation, each against one process's step from the same state
   and draws (loss, the whole gradient, running statistics at phase 6's
   train-mode gates; the U-Net's 21 launches a step on each process and its
   parameters), the processes bit-identical after each step, each
   process's ms a step for information; (c) ``Trainer.train`` (20 bf16
   ``unet`` steps, a validation every 10) on the two processes: process 0
   alone validates and writes the checkpoints and metrics (process 1 no
   file), the final parameters against one process's run;
13. the CLIs on the card (``unet_zoo_tpu_torch.training.cli``): first
   which of h5py, sklearn, PIL, cv2 and tensorboardX import here; (a)
   ``train_main`` then ``eval_main --checkpoint last --num-repeats 1
   --num-samples 4 --generate-images`` in this process for the registered
   ``unet`` (f32), a ``unet`` file in bf16, ``prob_unet``, ``phiseg_7_5_12``,
   ``phiseg_uzh_7_5_192`` and ``phiseg_brats`` (experiment files of a few
   iterations with one validation), from a synthetic LIDC pickle whose cache
   the CLI builds and synthetic UZH and BraTS caches where ``from_config``
   looks (npy directories where h5py does not import): the conv-chain
   launches of each call against the count its steps and images make, the
   provenance, checkpoints, the test sweep's npz with its schema, and the
   PNGs (10 images x (image, ground truth, 10 samples)) decoding to the
   model's shape, each call's seconds; and one ``python -m
   unet_zoo_tpu_torch.train`` in a subprocess; (b) ``loader="native"``: the
   g++ build, ``next_batch(12)`` on the native and the h5py-loader providers
   (host ms, bit-identical batches) and 3 ``unet`` steps through each loader,
   the losses bit-identical (cuDNN deterministic); (c)
   ``augment_on="host"``: 3 steps where cv2 imports, else the Trainer's
   ImportError; (d) ``eval_image`` of one ``phiseg_uzh_7_5_512`` image at 100
   samples decoded in chunks (ms, peak MiB), and at 16 samples the chunked
   evaluation bit for bit against the whole fold;
14. spatial sharding (``unet_zoo_tpu_torch.parallel.space``, the mesh's
   space axis): first the halo-tile kernel, each BN-free block at bs64 in
   bf16 run stage by stage on SPACE_RANKS tiles of h + 2 rows (the zero-
   padded rows a halo exchange gives) and cropped, against the unsplit
   kernel (bit for bit or not, said) and the plain version at phase 2's
   gates; then SPACE_RANKS processes sharing the one card over gloo
   (``chip_smoke.py --space-worker``), one data group split in height,
   started together with a time limit: (a) the bf16 ``unet`` step at bs64,
   128x128, filters 32/64/128/192, SPACE_UNET_STEPS steps, 21 conv-chain
   launches a step on each process, the first step's loss and gradient
   against one process's step from the same state and draws (phase 5's
   kernel-vs-plain gates), ms a step; (b) the registered
   ``phiseg_uzh_7_5_512`` step (f32, TF32 off, bs12, 512x512; each process
   within SPACE_MEMORY_FRACTION of the card) against one process's (phase
   6's train-mode gates), each process's peak MiB beside the one process's
   alone and within the same share, both of which must be higher, and one
   forward's graph MiB a process, at most SPACE_GRAPH_SHARE of one
   process's; (c) the twin of
   ``dryrun_multichip``: ``phiseg`` at the published widths 32-192, 64x64,
   two steps, then the tiny rank-5 PHiSeg3D step, losses finite. The
   processes hold one state after every step.

Then a JSON line of the kernels (with per-block times, bounds and cuDNN's
times at both batches), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is non-zero; without a GPU the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import importlib.util
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
# the float32 kernel's edges beyond EDGE_SHAPES: images smaller than a
# tile, folded several to a tile (1x1 x 40, 2x2 x 13 with a partial tile,
# 4x4 x 7, 3x5 x 3), C_in 384 and 1 (the plain loader), 9 (plain) and 4
# (TMA), odd C_out
F32_EDGE_SHAPES = [
    ((40, 1, 1, 384), [(384, 192)]),
    ((13, 2, 2, 9), [(9, 64), (64, 192)]),
    ((7, 4, 4, 4), [(4, 33), (33, 32)]),
    ((5, 4, 4, 1), [(1, 32)]),
    ((3, 3, 5, 384), [(384, 96)]),
]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W);
# float32 outside the tensor cores (CUDA-core FMA), and TF32 on them, of
# which 3xTF32 (three products a multiply-add) has a third
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_S = 3.35e12
# the machine code every kernel instantiation must hold, and must not
SASS_REQUIRED = ("HGMMA", "UTMALDG")
SASS_FORBIDDEN = ("HMMA",)
BF16_INSTANTIATIONS = 12  # conv3x3_bf16_wgmma<N, K chunk>: N 32/64/128/192 x chunk 16/32/64
F32_INSTANTIATIONS = 8  # conv3x3_f32_3xtf32_wgmma<N, K chunk>: N 32/64 x chunk 8/16/32, N 96 x 8/16
# max |kernel - plain| <= F32_RTOL * max|plain|: the f32 kernel's 3xTF32
# products lie ~2^-21 from f32 ones and its f32 sums run in another order
# than cuDNN's (TF32 off)
F32_RTOL = 1e-4
# max |kernel - 3xTF32 in plain PyTorch| <= F32_3XTF32_RTOL * max|plain|:
# the same products, the f32 sums in another order and the tensor cores'
# own accumulation within each K chunk (at most 6.7e-6 over a 3-stage
# block on an NVIDIA H100 80GB HBM3 at 700 W)
F32_3XTF32_RTOL = 2e-5
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
# ~20 ms of the card's clock: long enough for the host to enqueue a timed
# round behind it (``device_ms``)
SLEEP_CYCLES = 40_000_000
# the gradient of a bias that BatchNorm follows is the regularizer's term
# alone, REG_WEIGHT * b / sqrt(sum(b^2) + 1e-12), written out here from b:
# within REG_GRAD_RTOL of the term's max|value| (the model sums the norms
# with multi-tensor kernels, in another order)
REG_GRAD_RTOL = 1e-5
# what ``ops.conv.chain_route`` names the float32 kernel on a card
F32_ROUTE = "conv3x3_f32_3xtf32_wgmma"

# phase 10: PHiSeg3D and BraTS
BRATS_EXPERIMENT = "phiseg_brats"
BRATS_PARITY_SIZE = (32, 32, 32)  # phase 10 (a): the card against the CPU at a cut volume
BRATS_STEPS = 3
BRATS_TIME_STEPS = 2  # steps a timed round of ``step_times``
BRATS_VAL_VOLUMES = 2
BRATS_SAMPLES = 16  # the registered validation_samples
MIB = 2 ** 20

# phase 11: the UZH prostate path
UZH_EXPERIMENT = "phiseg_uzh_7_5_512"
UZH_REV_EXPERIMENT = "phiseg_uzh_rev_7_5_512"
UZH_PARITY = ("phiseg_uzh_7_5_192", "phiseg_uzh_rev_7_5_192")  # (a) at the smallest registered resolution
UZH_STEPS = 2  # the counted run of the registered step
UZH_TIMED_STEPS = 1  # (b): steps timed a mode after its warm-up (a strict-f32 step takes seconds)
UZH_SPLITS = (12, 9, 2)  # synthetic train / validation / test slices; validation > EVAL_IMAGE_WINDOW
UZH_SAMPLES = 16  # the registered validation_samples
UZH_MAT_SLICES, UZH_MAT_SIZE = 160, 192  # (e): 10 train, 100 validation, 50 test

# phase 12: data parallelism
DP_STEPS = 3  # (a): steps of each path from one seed, mesh and plain
DP_TIME_STEPS = 5  # (a): steps a timed round
DP_RANKS = 2  # (b), (c): processes sharing the one card over gloo
DP_RANK_STEPS = 2  # (b): steps of each path, each from the two processes' state before it
DP_PHISEG_BATCH = 12  # (b): the registered global batch, 6 a process
DP_TIMEOUT = 600  # seconds for the two processes' whole run
# (b) PHiSeg is held at phase 6's train-mode gates: its two processes take
# BatchNorm's statistics by the group's formula, max(E[x^2] - E[x]^2, 0) as
# the JAX package, where one process takes the library's Welford pass, and
# train-mode BatchNorm at the published depth amplifies that rounding (the
# gradient 3.0e-3 relative L2 at step 1, as JAX against the port on the CPU
# above). ``tools/torch_dp_faults.py`` read the first step with a fault
# planted on an NVIDIA H100 80GB HBM3 at 700 W: BatchNorm unsynced 1.29,
# gradients unreduced 1.54 (statistics 0.31 of their max unsynced), the f32
# U-Net's gradients unreduced 0.165 against 1.2e-6 without a fault; every
# gate below lies between the two readings
# (b) the float32 U-Net step at global bs64 on two processes against one,
# each step from the same state: the gradient (relative L2) within
# DP_F32_GRAD_L2 (the same per-image terms, cuDNN's weight gradients summed
# over 32 images a process, then over the two), every parameter within
# DP_PARAM_ATOL_LR lr but an entry whose gradient is within ROUNDING_OF_MAX of
# its tensor's max|g|, whose first Adam update lr * sign(g) may take the other
# sign, ROUNDING_FLIP_LR lr away, in at most FLIP_SHARE of all entries
DP_F32_GRAD_L2 = 1e-4
DP_PARAM_ATOL_LR, ROUNDING_OF_MAX, ROUNDING_FLIP_LR, FLIP_SHARE = 2e-2, 1e-3, 2.01, 1e-3
# (c) Trainer.train on two processes against one, bf16, free trajectories
# from one seed: the final parameters' distance from the one-process run's,
# relative to how far that run moved them (||p2 - p1|| / ||p1 - p0||). The
# bf16 weight gradients of 32 images a process round otherwise than those
# of 64, Adam's first update turns the entries near 0 into +-lr, and 20
# steps carry that on (0.048-0.084 measured, the worst entry 20.4 lr, on an
# NVIDIA H100 80GB HBM3 at 700 W); with a fault planted
# (``tools/torch_dp_faults.py``, same card) the processes end 0.53 of it
# away where both trained on the first half of every batch, 0.52 where each
# stepped on its own gradient
DP_TRAIN_REL_MOVE = 0.25

# phase 14: spatial sharding
SPACE_RANKS = 2  # processes sharing the one card over gloo: one data group, its height split in two
SPACE_TIMEOUT = 600  # seconds for the two processes' whole run
SPACE_UNET_STEPS = 2  # (a): the first held against one process, both timed
SPACE_UZH_ONE_PEAK_MIB = 48972.5  # (b): the one-process peak phase 11 recorded (PERF.md), printed beside this run's
# each process may take this share of the card's memory: the two share it,
# and a strict-f32 cuDNN convolution takes the largest workspace that the
# allocator grants (an FFT forward of tens of GiB at 512x512), so without a
# share the first process to ask starves the other (out of memory at 78.5
# GiB on an NVIDIA H100 80GB HBM3, PERF.md); within its share cuDNN takes the plans
# whose workspace fits
SPACE_MEMORY_FRACTION = 0.47
# (b): the most of one process's forward graph (the autograd graph's saved
# tensors) that a space-2 process may hold: half the rows plus the halo
# tiles' copies read 60.8% on an NVIDIA H100 80GB HBM3 (PERF.md), a layout
# that kept most levels replicated would read near 100%
SPACE_GRAPH_SHARE = 0.75
# (c): the twin of dryrun_multichip (__graft_entry__.py): PHiSeg at the
# published widths on a small image, two steps; then the tiny PHiSeg3D
SPACE_DRYRUN_FILTERS = (32, 64, 128, 192, 192, 192, 192)
SPACE_DRYRUN_SIZE = 64
SPACE_DRYRUN_3D = dict(filter_channels=(2, 4, 4), latent_levels=2, n_classes=3, num_labels_per_subject=1,
                       input_channels=4, image_size=(16, 16, 16))

# phase 13: the CLIs on the card
CLI_MODULES = ("h5py", "sklearn", "PIL", "cv2", "tensorboardX")
CLI_LIDC_CASES = (40, 10)  # the synthetic LIDC pickle: cases, subjects (24 / 8 / 8 images by the 64/16/20 split)
CLI_UZH_SPLITS = (12, 2, 2)  # synthetic UZH slices at 192x192: train (the batch) / validation / test
CLI_BRATS_SPLITS = (2, 1)  # synthetic BraTS volumes at 128^3: train / validation (test empty, as real BraTS)
CLI_VALIDATION_IMAGES = 2
CLI_TEST_SAMPLES = 4  # eval --num-samples
GENERATED = (10, 10)  # generate_images: images, samples each (the method's defaults, as the JAX CLI)
# (run, registered experiment, changes, iterations (one validation at the last), launches a step, launches
# an evaluated image, launches a generated image); the conv chain runs in the U-Net and ProbUNet's trunk
CLI_RUNS = (
    ("unet", "unet", {}, 2, 21, 21, 21),
    ("unet_bf16", "unet", {"dtype": "bfloat16", "experiment_name": "Unet_bf16"}, 2, 21, 21, 21),
    # an early ProbUNet validation's KL is NaN (phase 9 (g)): validated after 4 steps, as the harness does
    ("prob_unet", "prob_unet", {}, 4, 39, 78, 39),
    ("phiseg_7_5_12", "phiseg_7_5_12", {}, 2, 0, 0, 0),
    ("phiseg_uzh_7_5_192", "phiseg_uzh_7_5_192", {}, 2, 0, 0, 0),
    ("phiseg_brats", "phiseg_brats", {}, 2, 0, 0, 0),
)
NATIVE_STEPS = 3  # (b): steps of the native-loader and the h5py-loader run, bit-identical
NATIVE_TIMED_BATCHES = 20  # (b): next_batch(12) calls timed a provider
CHUNK_SAMPLES = (100, 16)  # (d): the fitting fold, and the fold compared whole and chunked


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
    """Kernel vs plain version on the same CUDA tensors, and in float32 vs
    the kernel's own 3xTF32 arithmetic in plain PyTorch; returns max |diff|
    from the plain version."""
    out = conv_chain.fused_conv_chain(x, ks, bs)
    ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype, f"{label}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(scale > 0, f"{label}: plain output is all zero")
    tol = F32_RTOL * scale if x.dtype == torch.float32 else BF16_ULPS * bf16_ulp(scale)
    emulated = ""
    if x.dtype == torch.float32:
        e_err = (out - conv_chain.fused_conv_chain_3xtf32(x, ks, bs)).abs().max().item()
        emulated = f"  3xTF32 plain {e_err / scale:.2e} of max (tol {F32_3XTF32_RTOL})"
        check(e_err <= F32_3XTF32_RTOL * scale, f"{label}: {e_err} from the 3xTF32 plain version")
    log(f"[kernel] {label:<44} max|diff| {err:.3e}  max|ref| {scale:.3e}  tol {tol:.3e}{emulated}")
    check(err <= tol, f"{label}: max|diff| {err} > tol {tol}")
    return err


def plan_line(conv_chain, shape, co, dtype) -> str:
    """The launch plan of one stage, for a log line."""
    if dtype == torch.float32:
        p = conv_chain.f32_launch_plan(shape, co)
        tile = f"{p.n_img}x{p.tile_h}x{p.tile_w} tile (images x rows x columns)"
    else:
        p = conv_chain.launch_plan(shape, co)
        tile = f"{p.tile_h}x16 tile"
    return (f"chunk {p.chunk}, {p.block_n} channels a block, {tile}, {p.items} items, {p.loader} loader, weights "
            f"{'resident' if p.resident else f'ring x{p.weight_stages}'}")


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
    """conv3x3_bf16_wgmma<BN, KC> or conv3x3_f32_3xtf32_wgmma<BN, KC> from a mangled name."""
    m = re.search(r"(conv3x3_bf16_wgmma|conv3x3_f32_3xtf32_wgmma)ILi(\d+)ELi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)},{m.group(3)}>" if m else mangled


def ptxas_report(build_log: str) -> dict:
    """Registers, spills and static shared memory per kernel, from ptxas -v;
    fails on any serialized wgmma (C7512, C7513, C7518) and on a spill in
    the f32 kernel. Returns {kernel: ptxas's line}."""
    name, spill, report, faults = None, "", {}, []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.split(":")[-1].strip() if ":" in line else line.strip()
            if (name or "").startswith("conv3x3_f32") and any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                faults.append(f"ptxas spills in {name}: {spill}")
        elif "Used" in line and name:
            report[name] = f"{line.split('Used', 1)[1].strip()}; {spill}"
            log(f"[ptxas] {name}: {report[name]}")
        if re.search(r"C751[238]", line) or "serialized" in line:
            faults.append(f"ptxas serialized the wgmma: {line.strip()}")
    check(not faults, "; ".join(faults))
    return report


def find_cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME

    for tool in (shutil.which("cuobjdump"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "cuobjdump")):
        if tool and os.access(tool, os.X_OK):
            return tool
    return None


def sass_check(lib_path, build_log: str) -> dict:
    """Every bf16 and f32 kernel instantiation issues wgmma and TMA loads and
    no mma.sync, and no other kernel is there (the f32 CUDA-core kernel
    ``conv3x3_f32_fma`` is gone): read from the machine code (cuobjdump
    -sass) where the toolkit has cuobjdump, else from the ptxas log (each
    entry compiled for sm_90a, which alone has wgmma, and no wgmma
    serialized). Returns {kernel: {op: count}}."""
    tool = find_cuobjdump()
    want = {"conv3x3_bf16_wgmma": BF16_INSTANTIATIONS, "conv3x3_f32_3xtf32_wgmma": F32_INSTANTIATIONS}
    if tool is None:
        entries = [kernel_name(m) for m in re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'", build_log)]
        for family, n in want.items():
            got = [e for e in entries if e.startswith(family + "<")]
            check(len(got) == n, f"ptxas compiled {len(got)} {family} kernels for sm_90a, expected {n}")
        check(len(entries) == sum(want.values()), f"ptxas compiled other kernels too: {entries}")
        log(f"[sass] no cuobjdump: ptxas compiled {len(entries)} wgmma kernels for sm_90a, none serialized")
        return {e: {} for e in entries}
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
    for family, n in want.items():
        got = [k for k in counts if k.startswith(family + "<")]
        check(len(got) == n, f"{len(got)} {family} kernels in the library's machine code, expected {n}")
    check(len(counts) == sum(want.values()) and "conv3x3_f32_fma" not in sass,
          f"other kernels in the library's machine code: {sorted(counts)}")
    for k, v in counts.items():
        log(f"[sass] {k}: " + ", ".join(f"{op} {n}" for op, n in v.items()))
        check(all(v[op] > 0 for op in SASS_REQUIRED) and not any(v[op] for op in SASS_FORBIDDEN),
              f"{k}: machine code {v}, needs {SASS_REQUIRED} and none of {SASS_FORBIDDEN}")
    return counts


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


def device_ms(fn, iters: int) -> float:
    """Like ``cuda_ms``, with the host's issue taken out: a sleep kernel
    holds the stream while the host enqueues every call, so the events read
    the device's time alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """The host's ms to issue one call while the device is busy."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    took = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return took


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


def phiseg_parity(dev, experiment: str = PHISEG_EXPERIMENT, modes=(True, False), size: int = IMAGE) -> dict:
    """(a): float32, the same weights and z noise on the card and the CPU, in
    train mode (``True`` in ``modes``) and eval mode (``False``), at
    ``size`` x ``size``, with labels of every class of the experiment.
    Returns each mode's readings."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    cfg = dataclasses.replace(get_experiment(experiment), image_size=(size, size))
    models = {d: get_model("phiseg", **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((PHISEG_PARITY_BATCH, size, size, 1), generator=gen)
    smooth = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4)[:, 0]
    y = sum((smooth > 0.1 * c).long() for c in range(cfg.n_classes - 1))  # smooth is ~N(0, 0.11^2)
    first = len(cfg.filter_channels) - cfg.latent_levels
    eps = {kind: [torch.randn((PHISEG_PARITY_BATCH, size >> (lvl + first), size >> (lvl + first), cfg.zdim),
                              generator=gen) for lvl in range(cfg.latent_levels)] for kind in ("post", "prior")}
    result = {}
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
        log(f"[phiseg] {experiment} f32 {mode} mode, card vs CPU, batch {PHISEG_PARITY_BATCH} {size}x{size}, "
            f"{cfg.n_classes} classes, {len(g_c)} gradients: outputs "
            f"{out_err:.3e} of max|ref| (tol {of_max}), loss/kl/recon rel {loss_err:.3e} (tol {PHISEG_LOSS_RTOL}), "
            f"gradient rel L2 {l2:.3e}, worst tensor {worst_name} {per_tensor:.3e} of its max|g| ({tol})")
        result[mode] = {"outputs_of_max": out_err, "loss_rel": loss_err, "grad_rel_l2": l2,
                        "worst_tensor_of_max": per_tensor}
    del models
    return result


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

    images, labels = trainer._upload(data.validation, 0, n_val)
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
            f"loss repeats): the evaluation (evaluate_images, enqueue and device work) {sum(eval_s):.3f} s, "
            f"{sum(eval_s) / n_val:.4f} s an image; the whole validate() with its checkpoints {val_s:.3f} s, "
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
        result[name] = {"eval_launches": eval_launches, "validation_eval_s_per_image": sum(eval_s) / n_val,
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
        return rev.ReversibleChain.apply(x, None, *ps)[0]

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
    noise on the card (its trunk on ``conv3x3_f32_3xtf32_wgmma``) and on the CPU (the
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
        log(f"[prob_unet] f32 {mode} mode, card ({launched} launches of {F32_ROUTE}) vs CPU, batch "
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
    version and cuDNN conv+bias+ReLU (TF32 off), CUDA events, the min of 5
    rounds of F32_BLOCK_ITERS: ``ms`` the device's time with the host's
    issue (its plan, tensor maps and launch, or cuDNN's) taken out, the same
    way for every route (``device_ms``); ``event_ms`` with the host issuing
    as the device runs (how the rows of the earlier, CUDA-core f32 kernel
    were timed), which at 2x2-8x8 is the host's pace; ``host_ms`` the
    host's time to issue one call. Beside two
    bounds: at the f32 CUDA-core peak (``fma_bound_ms``) and at the 3xTF32
    rate (``bound_ms``), each the larger of its FLOPs and the chain's f32
    bytes at the memory rate."""
    batch, size, _, ci = x.shape
    chans = [(k.shape[1], k.shape[0]) for k in ks]
    packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
    calls = {"kernel": lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed),
             "plain": lambda: conv_chain.fused_conv_chain_reference(x, ks, bs),
             "cudnn": lambda: cudnn_chain(x, ks, bs)}
    t = {(name, how): min(timer(fn, F32_BLOCK_ITERS) for _ in range(5)) for name, fn in calls.items()
         for how, timer in (("ms", cuda_ms), ("device", device_ms), ("host", host_ms))}
    k_ms, p_ms, c_ms = t["kernel", "device"], t["plain", "device"], t["cudnn", "device"]
    cost = chain_cost(batch, size, chans, itemsize=4)
    f_ms, f_by = bound(*cost, PEAK_F32_FLOPS)
    b_ms, b_by = bound(*cost, PEAK_3XTF32_FLOPS)
    log(f"[time] f32 {block} ({batch}, {size}, {size}, {ci})->{chans[-1][1]} x3, device ms: {F32_ROUTE} {k_ms:.4f} "
        f"(event {t['kernel', 'ms']:.4f}, host issue {t['kernel', 'host']:.4f}; {b_ms / k_ms:.1%} of its "
        f"{b_ms:.4f} ms bound by {b_by} at 3xTF32, 494.7/3 TFLOP/s; {f_ms / k_ms:.1%} of {f_ms:.4f} ms by {f_by} at "
        f"67 TFLOP/s f32 FMA), plain {p_ms:.4f}, cuDNN f32 conv+bias+ReLU (TF32 off) {c_ms:.4f} (event "
        f"{t['cudnn', 'ms']:.4f}, host issue {t['cudnn', 'host']:.4f}), kernel/cuDNN {k_ms / c_ms:.3f} | card: {card}")
    return {"block": block, "batch": batch, "ms": k_ms, "plain_ms": p_ms, "library_ms": c_ms, "bound_ms": b_ms,
            "bound_by": b_by, "fma_bound_ms": f_ms, "fma_bound_by": f_by, "event_ms": t["kernel", "ms"],
            "host_ms": t["kernel", "host"], "library_event_ms": t["cudnn", "ms"],
            "library_host_ms": t["cudnn", "host"]}


def prob_blocks(conv_chain, dev, card: str) -> dict:
    """(b): the 13 trunk block shapes at each batch the ProbUNet path gives
    the kernel (PROB_CHECK_BATCHES: the launch plan's tiles and items depend
    on the batch), kernel against plain in float32 and bf16 (each stage's
    plan logged), REPEATS relaunches of each float32 block at batch 12
    against the first, bit for bit, and the float32 kernel's time per block
    at batch 12 at those shapes and at the U-Net's 7."""
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
                    for c_in, c_out in chans[:2]:
                        log(f"[plan]   {block} bs{batch} {c_in}->{c_out} at {size}x{size}: "
                            f"{plan_line(conv_chain, (batch, size, size, c_in), c_out, dtype)}")
                    if dtype == torch.float32 and batch == PROB_BATCH:
                        packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
                        first = conv_chain.fused_conv_chain(x, ks, bs, packed=packed)
                        differ = sum(not torch.equal(conv_chain.fused_conv_chain(x, ks, bs, packed=packed), first)
                                     for _ in range(REPEATS))
                        log(f"[repeat] f32 prob_unet {block} bs{batch}: {REPEATS - differ} of {REPEATS} repeated "
                            f"launches bit-identical to the first")
                        check(differ == 0, f"f32 {block} bs{batch}: {differ} of {REPEATS} repeated launches differ")
                        rows["prob_unet"].append(f32_block_row(conv_chain, x, ks, bs, f"prob_unet {block}", card))
                    del x
        for block, size, ci, co in BLOCKS:
            chans = [(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1)
            x = torch.randn((PROB_BATCH, size, size, ci), generator=gen).to(dev)
            ks, bs = chain_weights(chans, gen, dev)
            rows["unet"].append(f32_block_row(conv_chain, x, ks, bs, f"unet {block}", card))
            del x
    for net, rs in rows.items():
        k, e, c, ce, b, f = (sum(r[key] for r in rs) for key in ("ms", "event_ms", "library_ms", "library_event_ms",
                                                                 "bound_ms", "fma_bound_ms"))
        log(f"[time] f32 {net} trunk, {len(rs)} blocks at bs{PROB_BATCH}, device ms: {F32_ROUTE} {k:.3f} (event "
            f"{e:.3f}), cuDNN f32 {c:.3f} (event {ce:.3f}; kernel/cuDNN {k / c:.3f}), bound {b:.3f} ms at 3xTF32 "
            f"({b / k:.1%}), {f:.3f} ms at f32 FMA ({f / k:.1%}) | card: {card}")
    log(f"[kernel] prob_unet trunk: {len(errs)} block checks ({len(PROB_BLOCKS)} blocks x batches "
        f"{PROB_CHECK_BATCHES} x f32, bf16) all within tolerance")
    n = len(PROB_BLOCKS) * len(PROB_CHECK_BATCHES)
    return {"rows": rows, "max_abs_err": max(errs), "f32_max_abs_err": max(errs[:n])}


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


def f32_step(conv_chain, dev, card: str, log_dir: str, experiment: str, launches: int, batch=None) -> dict:
    """(d): a registered float32 step (``prob_unet``: 39 launches of the
    float32 kernel; ``unet`` at batch 12: 21), and its ms beside the same
    step with every trunk block on cuDNN f32 (the chain's plain version in
    place of the kernel's wrapper, ``plain_chain``; TF32 off as ``Trainer``
    sets it), in turns, each with the host's time to issue one step onto an
    idle device (the min of MODE_TIME_STEPS)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment(experiment)
    check(cfg.dtype == "float32", f"{experiment} is registered in {cfg.dtype}")
    cfg = dataclasses.replace(cfg, batch_size=batch or cfg.batch_size)
    xs, ys = train_batches(1, dev, cfg.batch_size)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    check(trainer.chain_route == F32_ROUTE, f"f32 chains route to {trainer.chain_route}")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "Trainer left TF32 on for a float32 experiment")
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    conv_chain.launches = 0
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    launched = conv_chain.launches
    check(launched == launches, f"f32 {experiment} step: {launched} launches of {F32_ROUTE}")
    ms = {"kernel": math.inf, "cudnn": math.inf}
    host = dict(ms)
    for route in ("kernel", "cudnn", "cudnn", "kernel"):
        with plain_chain() if route == "cudnn" else contextlib.nullcontext():
            ms[route] = min(ms[route], cuda_ms(lambda: trainer.train_step(xs[0], ys[0]), MODE_TIME_STEPS))
            for _ in range(MODE_TIME_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(xs[0], ys[0])
                host[route] = min(host[route], (time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    check(conv_chain.launches == launched + 2 * (2 * MODE_TIME_STEPS + 1) * launches,
          f"f32 timing: {conv_chain.launches - launched} launches, expected the kernel's rounds only")
    log(f"[time] {experiment} f32 train step bs{cfg.batch_size} as registered ({launched} launches of "
        f"{F32_ROUTE} a step): {ms['kernel']:.3f} ms, host issue {host['kernel']:.3f} ms; the same step with the "
        f"trunk on cuDNN f32, TF32 off: {ms['cudnn']:.3f} ms, host issue {host['cudnn']:.3f} ms (min of 2 rounds of "
        f"{MODE_TIME_STEPS} each, in turns) | card: {card}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launched, "ms": ms["kernel"], "cudnn_ms": ms["cudnn"], "host_ms": host["kernel"],
            "cudnn_host_ms": host["cudnn"]}


def prob_unet_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 9: the Probabilistic U-Net, plain and reversible."""
    t0 = time.perf_counter()
    parity = prob_parity(conv_chain, dev)
    blocks = prob_blocks(conv_chain, dev, card)
    plain = mode_slice(conv_chain, dev, card, log_root, PROB_EXPERIMENT, launches=PROB_LAUNCHES,
                       gates=prob_grad_gates, time_steps=TIME_STEPS)
    f32 = f32_step(conv_chain, dev, card, log_root, PROB_EXPERIMENT, PROB_LAUNCHES)
    f32_unet = f32_step(conv_chain, dev, card, log_root, "unet", len(BLOCKS) * STAGES_PER_BLOCK, batch=PROB_BATCH)
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
    return {"parity": parity, "blocks": blocks, "plain": plain, "f32": f32, "f32_unet": f32_unet, "eval": evaluation,
            "rev": rev, "rev_eval": rev_eval, "harness": harnessed}


def brats_volumes(size, n_train: int, n_val: int):
    """Synthetic BraTS arrays (``data.synthetic.brats_arrays``, crop offsets
    included) from a fixed seed, and the train volumes as device batches
    of one with their one-hot WT/TC/ET labels."""
    from unet_zoo_tpu_torch.data import synthetic
    from unet_zoo_tpu_torch.data.brats import to_evaluation_onehot

    arrays = synthetic.brats_arrays((n_train, n_val), size, seed=0, keep_offsets=True)
    xs = [torch.from_numpy(arrays["images_train"][i:i + 1]) for i in range(n_train)]
    ys = [torch.from_numpy(to_evaluation_onehot(arrays["masks_train"][i:i + 1])) for i in range(n_train)]
    return arrays, xs, ys


def brats_parity(conv_chain, dev) -> dict:
    """Phase 10 (a): ``phiseg_brats``'s architecture at BRATS_PARITY_SIZE,
    batch 1, float32 with TF32 off, plain and reversible: the same weights
    and z noise on the card and the CPU, eval mode (outputs, loss terms,
    each gradient tensor's relative L2) and train mode (outputs, loss terms,
    the whole gradient, running statistics), at phase 9 (a)'s gates; no
    conv-chain launch, and a BN-free 3D conv sequence raises on the card."""
    from unet_zoo_tpu_torch import ops
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    seq = ops.ConvSeq(4, 8, 2, ndim=3, device=dev)
    try:
        seq(torch.zeros((1, 4, 4, 4, 4), device=dev))
        raise AssertionError("a BN-free 3D conv sequence ran on the card")
    except NotImplementedError as e:
        log(f"[brats] a BN-free 3D conv sequence on the card raises: {e}")
    _, xs, ys = brats_volumes(BRATS_PARITY_SIZE, 1, 0)
    x, y = xs[0], ys[0]
    result = {}
    for mode in ("plain", "reversible"):
        cfg = dataclasses.replace(get_experiment(BRATS_EXPERIMENT), image_size=BRATS_PARITY_SIZE, reversible_mode=mode)
        models = {d: get_model(cfg.model, **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
                  for d in ("cpu", dev)}
        gen = torch.Generator().manual_seed(6)
        eps = {kind: [torch.randn((1, *[s >> (lvl + 1) for s in BRATS_PARITY_SIZE], cfg.zdim), generator=gen)
                      for lvl in range(cfg.latent_levels)] for kind in ("post", "prior")}
        for train in (False, True):
            phase = "train" if train else "eval"
            models[dev].load_state_dict(models["cpu"].state_dict())  # the same running statistics
            runs = {"cpu": phiseg_run(models["cpu"], x, y, eps["post"], eps["prior"], train)}
            torch.cuda.synchronize()
            conv_chain.launches = 0
            to = (lambda t: t.to(dev))  # noqa: E731
            runs[dev] = phiseg_run(models[dev], to(x), to(y), [to(e) for e in eps["post"]],
                                   [to(e) for e in eps["prior"]], train)
            torch.cuda.synchronize()
            check(conv_chain.launches == 0, f"PHiSeg3D launched the conv-chain kernel {conv_chain.launches} times")
            (out_c, aux_c, g_c), (out_g, aux_g, g_g) = runs["cpu"], runs[dev]
            of_max = PHISEG_TRAIN_OF_MAX if train else PHISEG_EVAL_OF_MAX
            out_err = max((a.detach().cpu() - b.detach()).abs().max().item() / b.detach().abs().max().item()
                          for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma")
                          for a, b in zip(out_g[key], out_c[key]))
            check(out_err <= of_max, f"PHiSeg3D {mode} f32 {phase} outputs: {out_err:.3e} of max|ref| > {of_max}")
            loss_err = max(abs(aux_g[k].item() - aux_c[k].item()) / abs(aux_c[k].item())
                           for k in ("loss", "kl", "recon"))
            check(loss_err <= PHISEG_LOSS_RTOL, f"PHiSeg3D {mode} f32 {phase} loss terms: rel diff {loss_err:.3e}")
            missing = [n for n in g_c if g_c[n] is None or g_g[n] is None]
            check(not missing, f"PHiSeg3D {mode} f32 {phase}: no gradient in {missing}")
            flat = {d: torch.cat([g[n].detach().cpu().flatten() for n in g_c]) for d, g in (("cpu", g_c), (dev, g_g))}
            l2 = ((flat[dev] - flat["cpu"]).norm() / flat["cpu"].norm()).item()
            check(l2 <= PHISEG_TRAIN_GRAD_L2, f"PHiSeg3D {mode} f32 {phase} gradient: rel L2 {l2:.3e}")
            tensor_l2, worst = max((((g_g[n].cpu() - g_c[n]).norm() / g_c[n].norm()).item(), n)
                                   for n in g_c if g_c[n].any())
            tol = f"tol L2 {PHISEG_TRAIN_GRAD_L2}"
            if not train:
                check(tensor_l2 <= PROB_EVAL_TENSOR_L2, f"PHiSeg3D {mode} eval gradient {worst}: rel L2 {tensor_l2:.3e}")
                tol += f", each tensor's {PROB_EVAL_TENSOR_L2}"
            else:
                gpu_buffers = dict(models[dev].named_buffers())
                stats_err = max(((gpu_buffers[n].cpu() - b).abs().max() / b.abs().max()).item()
                                for n, b in models["cpu"].named_buffers())
                check(stats_err <= PHISEG_STATS_RTOL, f"PHiSeg3D {mode} running statistics: rel diff {stats_err:.3e}")
                tol += f"; running statistics rel {stats_err:.3e}, tol {PHISEG_STATS_RTOL}"
            log(f"[brats] {BRATS_EXPERIMENT} {mode} f32 {phase} mode at {BRATS_PARITY_SIZE}, batch 1, card vs CPU, "
                f"{len(g_c)} gradients: outputs {out_err:.3e} of max|ref| (tol {of_max}), loss/kl/recon rel "
                f"{loss_err:.3e} (tol {PHISEG_LOSS_RTOL}), whole gradient rel L2 {l2:.3e} ({tol}); worst tensor "
                f"{worst} rel L2 {tensor_l2:.3e}")
            result[f"{mode}_{phase}"] = {"outputs_of_max": out_err, "loss_rel": loss_err, "grad_rel_l2": l2,
                                         "worst_tensor_rel_l2": tensor_l2}
        del models
    return result


def brats_step(dev, card: str, log_dir: str, xs, ys, label: str, **changes) -> dict:
    """One ``phiseg_brats`` Trainer (as registered, with ``changes``): a
    warm-up step, then ``step_times`` over BRATS_TIME_STEPS steps; ms a step
    (events), the host's issue ms, the phases and the peak MiB over them
    above what the card held before this trainer was built (its weights,
    Adam's moments and the step's own memory; not the phase's other state)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(BRATS_EXPERIMENT), **changes)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir, tensorboard=False)
    x, y = xs[0], ys[0]
    loss = trainer.train_step(x, y)["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = step_times(trainer, x, y, BRATS_TIME_STEPS)
    t["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    check(bool(torch.isfinite(loss)), f"{label}: non-finite loss {loss.item()}")
    phases = t["phases_ms"]
    log(f"[time] {label} train step bs1 128^3 with 3D augmentation: {t['ms']:.3f} ms, host issue {t['host_ms']:.3f} "
        f"ms (median {t['host_median_ms']:.3f}), peak {t['peak_mib']:.1f} MiB above the card's other state; phases, ms/step: augmentation "
        f"{phases[0]:.3f}, forward+loss {phases[1]:.3f}, backward {phases[2]:.3f}, optimizer+plateau "
        f"{phases[3]:.3f} | card: {card}")
    trainer.close()
    return t


def brats_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 10: PHiSeg3D and the BraTS path (parity, the registered step and
    its variants, validation, test and the NIfTI export)."""
    from unet_zoo_tpu_torch.data import BratsData
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.metrics import hd95
    from unet_zoo_tpu_torch.training import Trainer
    from unet_zoo_tpu_torch.training.trainer import VOLUME_SAMPLE_CHUNK
    from unet_zoo_tpu_torch.utils import load_nii

    t0 = time.perf_counter()
    parity = brats_parity(conv_chain, dev)
    torch.cuda.empty_cache()

    # (b) the registered step: f32, reversible, 128^3, batch 1, 3D augmentation with the elastic field
    size = (IMAGE,) * 3
    arrays, xs, ys = brats_volumes(size, BRATS_STEPS, BRATS_VAL_VOLUMES)
    xs, ys = [t.to(dev) for t in xs], [t.to(dev) for t in ys]
    log_dir = os.path.join(log_root, "brats")
    cfg = get_experiment(BRATS_EXPERIMENT)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    model = trainer.state.model
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    conv_chain.launches = 0
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    zero_bias_gates(model, before, cfg, f"{BRATS_EXPERIMENT} f32")
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside a step raises
    for i in range(1, BRATS_STEPS):
        losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(conv_chain.launches == 0, f"the PHiSeg3D step launched the conv-chain kernel {conv_chain.launches} times")
    same = [n for n, b in model.named_buffers() if torch.equal(b, stats0[n])]
    check(not same, f"running statistics that did not change: {same}")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    log(f"[brats] {BRATS_STEPS} registered steps ({cfg.dtype}, {cfg.effective_reversible_mode}, bs1 128^3x4, 3D "
        f"augmentation with the elastic field): no host sync inside a step, 0 conv-chain launches, "
        f"{len(stats0)} running statistics all changed; losses {' '.join(f'{v:.1f}' for v in losses.tolist())}")
    steps = {"registered": brats_step(dev, card, log_dir, xs, ys, f"{BRATS_EXPERIMENT} f32 reversible"),
             "plain": brats_step(dev, card, log_dir, xs, ys, f"{BRATS_EXPERIMENT} f32 plain", reversible_mode="plain"),
             "bf16": brats_step(dev, card, log_dir, xs, ys, f"{BRATS_EXPERIMENT} bf16 reversible", dtype="bfloat16")}
    torch.cuda.empty_cache()

    # (c) evaluation on the registered trainer: the sample fold, validate, test and the export
    x = xs[0]
    folds = {}
    with torch.inference_mode():
        for chunk in (None, VOLUME_SAMPLE_CHUNK):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ms = min(cuda_ms(lambda: model.sample(x, BRATS_SAMPLES, chunk=chunk), 1) for _ in range(2))
            folds[chunk or BRATS_SAMPLES] = {"ms": ms, "peak_mib": (torch.cuda.max_memory_allocated(dev) - base) / MIB}
            log(f"[brats] sample(x, {BRATS_SAMPLES}) at 128^3 f32, {chunk or BRATS_SAMPLES} samples decoded at a time: "
                f"{ms:.1f} ms, peak {folds[chunk or BRATS_SAMPLES]['peak_mib']:.1f} MiB above the state | card: {card}")
    data = BratsData(arrays, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    agg = trainer.validate(data)
    val_s = (time.perf_counter() - t1) / BRATS_VAL_VOLUMES
    val_peak = torch.cuda.max_memory_allocated(dev) / MIB
    check(all(math.isfinite(agg[k]) for k in ("loss", "kl", "recon")), f"non-finite validation loss: {agg}")
    check(all(0.0 <= agg[f"dice_{r}"] <= 1.0 for r in ("wt", "tc", "et")), f"validation Dice outside [0, 1]: {agg}")
    for name in ("validation_ckpt", "best_dice", "best_loss"):
        check(os.path.exists(os.path.join(log_dir, name)), f"no {name} after validate_brats")
    t1 = time.perf_counter()
    res = trainer.test(data, num_repeats=1, num_samples=BRATS_SAMPLES, checkpoint="best_loss")
    test_s = (time.perf_counter() - t1) / BRATS_VAL_VOLUMES
    with np.load(os.path.join(log_dir, "brats_test_results.npz")) as f:
        check(all(f[k].shape == (1, BRATS_VAL_VOLUMES, 3) for k in ("dice", "sensitivity", "specificity", "hd95")),
              f"brats_test_results.npz: {dict((k, f[k].shape) for k in f.files)}")
    t1 = time.perf_counter()
    paths = trainer.export_predictions(data, num_samples=BRATS_SAMPLES)
    export_s = (time.perf_counter() - t1) / BRATS_VAL_VOLUMES
    check(len(paths) == BRATS_VAL_VOLUMES, f"exported {len(paths)} files")
    for ii, path in enumerate(paths):
        vol = load_nii(path)[0]
        orig = tuple(int(s) for s in arrays["origShape_validation"][ii])
        check(vol.shape == orig and vol.dtype == np.uint8 and set(np.unique(vol).tolist()) <= {0, 1, 2, 4},
              f"{path}: {vol.shape} {vol.dtype} labels {np.unique(vol).tolist()}, want {orig}")
    wt = data.get(0, "validation")[1][..., 0]
    t1 = time.perf_counter()
    hd = hd95(np.roll(wt, 3, axis=1), wt)
    hd_s = time.perf_counter() - t1
    log(f"[brats] validate_brats: {BRATS_VAL_VOLUMES} volumes x {BRATS_SAMPLES} samples at 128^3, {val_s:.3f} s a volume "
        f"(the checkpoint writes included), peak {val_peak:.1f} MiB; test_brats 1 repeat {test_s:.3f} s a volume; "
        f"export_predictions {export_s:.3f} s a volume, {len(paths)} .nii.gz read back in the original geometry with "
        f"labels in {{0, 1, 2, 4}}; HD95 of one region on the host {hd_s:.3f} s ({hd:.2f} voxels for a 3-voxel "
        f"shift); validation dice WT {agg['dice_wt']:.4f}, loss {agg['loss']:.1f}; test dice {res['dice'][0]:.4f} "
        f"| card: {card}")
    trainer.close()
    log(f"[brats] phase 10 took {time.perf_counter() - t0:.1f} s")
    return {"parity": parity, "steps": steps, "folds": folds, "validation_s_per_volume": val_s,
            "validation_peak_mib": val_peak, "test_s_per_volume": test_s, "export_s_per_volume": export_s,
            "hd95_s": hd_s}


def uzh_step(dev, card: str, log_dir: str, x, y, label: str, experiment: str = UZH_EXPERIMENT, tf32: bool = False,
             **changes) -> dict:
    """One Trainer of ``experiment`` (with ``changes`` and cuDNN's TF32 as
    ``tf32`` says): a warm-up step, then UZH_TIMED_STEPS steps each timed by
    events around its phases; ``ms`` and ``phases_ms`` of the fastest, the
    host's time to issue it (``host_ms``), and the peak MiB over them above
    what the card held before this trainer was built."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(experiment), **changes)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir, tensorboard=False, tf32=tf32)
    loss = trainer.train_step(x, y)["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(UZH_TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t0 = time.perf_counter()
        ev[0].record()
        xa, ya = trainer.augment(x, y)
        ev[1].record()
        loss, _ = trainer.forward_loss(xa, ya)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update(loss)
        ev[4].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        runs.append({"ms": ev[0].elapsed_time(ev[4]), "host_ms": host_ms,
                     "phases_ms": [ev[k].elapsed_time(ev[k + 1]) for k in range(4)]})
    t = min(runs, key=lambda r: r["ms"])
    t["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    check(bool(torch.isfinite(loss)), f"{label}: non-finite loss {loss.item()}")
    phases = t["phases_ms"]
    log(f"[time] {label} train step bs{x.shape[0]} {x.shape[1]}x{x.shape[2]} with 3-label augmentation: {t['ms']:.3f} "
        f"ms, host issue {t['host_ms']:.3f} ms, peak {t['peak_mib']:.1f} MiB above the card's other state; phases, "
        f"ms: augmentation {phases[0]:.3f}, forward+loss {phases[1]:.3f}, backward {phases[2]:.3f}, "
        f"optimizer+plateau {phases[3]:.3f} | card: {card}")
    trainer.close()
    return t


def uzh_validation(trainer, data, dev, card: str) -> dict:
    """(d): ``sample(x, 16)`` of one image; the windowed upload's peak beside
    the whole split's; ``validate`` over "all" validation images (16 samples,
    6 annotators, 3 classes) with no host sync while it enqueues; ``test``
    with 1 repeat."""
    from unet_zoo_tpu_torch.training.trainer import EVAL_IMAGE_WINDOW

    cfg, model, log_dir = trainer.cfg, trainer.state.model, trainer.log_dir
    n_val, n_test = data.validation.images.shape[0], data.test.images.shape[0]
    check(n_val > EVAL_IMAGE_WINDOW, f"{n_val} validation images, not more than a window ({EVAL_IMAGE_WINDOW})")
    x = torch.from_numpy(np.asarray(data.validation.images[:1], dtype=np.float32)[..., None]).to(dev)
    model.eval()
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        sample_ms = min(cuda_ms(lambda: model.sample(x, UZH_SAMPLES), 1) for _ in range(2))
        sample_peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    model.train()
    size = x.shape[1]
    log(f"[uzh] sample(x, {UZH_SAMPLES}) at batch 1, {size}x{size} f32: {sample_ms:.1f} ms, peak {sample_peak:.1f} MiB "
        f"above the state | card: {card}")

    # the upload: one window as validate makes it, against the whole split as int64 at once (the old way)
    uploads = {}
    for name, upload in (("window", lambda: trainer._upload(data.validation, 0, EVAL_IMAGE_WINDOW)),
                         ("whole split", lambda: (
                             torch.from_numpy(np.asarray(data.validation.images[:], np.float32)[..., None]).to(dev),
                             torch.from_numpy(np.moveaxis(np.asarray(data.validation.labels[:]), -1, 1)
                                              .astype(np.int64)).to(dev)))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        held = upload()
        torch.cuda.synchronize()
        uploads[name] = (torch.cuda.max_memory_allocated(dev) - base) / MIB
        del held
    log(f"[uzh] evaluation upload at {size}x{size}, 6 annotators: one window of {EVAL_IMAGE_WINDOW} images "
        f"(labels as uint8, widened on the card) peaks at {uploads['window']:.1f} MiB; the whole split of {n_val} "
        f"at once with int64 labels {uploads['whole split']:.1f} MiB ({uploads['whole split'] / n_val:.2f} MiB an "
        f"image, growing with the split) | card: {card}")

    saves, save, eval_s = [], trainer.save_model, []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with no_sync_enqueue(trainer, eval_s), \
            mock.patch.object(trainer, "save_model", lambda n: (saves.append(n), save(n))):
        agg = trainer.validate(data)
    val_s = time.perf_counter() - t0
    val_peak = torch.cuda.max_memory_allocated(dev) / MIB
    check(math.isfinite(agg["ged"]) and -1.0 <= agg["ncc"] <= 1.0 and 0.0 <= agg["dice"] <= 1.0
          and all(math.isfinite(agg[k]) for k in ("loss", "kl", "recon")), f"UZH validation {agg}")
    check(len(eval_s) == -(-n_val // EVAL_IMAGE_WINDOW), f"{len(eval_s)} windows for {n_val} images")
    t0 = time.perf_counter()
    res = trainer.test(data, num_repeats=1, num_samples=UZH_SAMPLES, checkpoint="best_loss")
    test_s = (time.perf_counter() - t0) / n_test
    with np.load(os.path.join(log_dir, "test_results.npz")) as f:
        shapes = {k: f[k].shape for k in f.files}
    check(shapes == {"ged": (1, n_test), "ncc": (1, n_test), "dice": (1, n_test, cfg.n_classes)},
          f"test_results.npz {shapes}")
    log(f"[uzh] validate, \"all\" {n_val} images x {UZH_SAMPLES} samples (and loss repeats) at {size}x{size} f32 in "
        f"{len(eval_s)} windows of at most {EVAL_IMAGE_WINDOW}, no host sync while it enqueues: "
        f"{sum(eval_s) / n_val:.3f} s an image for the evaluation, {val_s / n_val:.3f} s an image with its "
        f"{len(saves)} checkpoint writes ({', '.join(saves)}), peak {val_peak:.1f} MiB of the card's whole "
        f"allocation; ged {agg['ged']:.4f} ncc {agg['ncc']:.4f} dice {agg['dice']:.4f}; test (1 repeat, "
        f"{UZH_SAMPLES} samples) {test_s:.3f} s an image, test_results.npz {shapes}, dice {res['dice'][0]:.4f} "
        f"| card: {card}")
    return {"sample16_ms": sample_ms, "sample16_peak_mib": sample_peak, "upload_window_mib": uploads["window"],
            "upload_whole_split_mib": uploads["whole split"], "validation_eval_s_per_image": sum(eval_s) / n_val,
            "validation_with_checkpoints_s_per_image": val_s / n_val, "validation_peak_mib": val_peak,
            "test_s_per_image": test_s}


def uzh_mat(dev, log_dir: str) -> None:
    """(e): ``UZHMatData`` over a ``.mat`` written by ``scipy.io.savemat``: the
    10/100/50 split, the batches' shapes and dtypes, one train step (batch
    2 of the 10 train slices) of ``phiseg_uzh_7_5_192``."""
    import scipy.io

    from unet_zoo_tpu_torch.data import UZHMatData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    arrays = synthetic.uzh_arrays((UZH_MAT_SLICES, 0, 0), UZH_MAT_SIZE, seed=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_uzh_mat_") as tmp:
        path = os.path.join(tmp, "uzh.mat")
        scipy.io.savemat(path, {"images": arrays["images_train"], "labels": arrays["masks_train"]})
        data = UZHMatData(path, seed=0)
    sizes = [len(getattr(data, s).indices) for s in ("train", "validation", "test")]
    check(sizes == [10, 100, 50], f"UZHMatData splits {sizes}")
    for split in ("train", "validation", "test"):
        x, y = getattr(data, split).next_batch(2)
        check(x.shape == (2, UZH_MAT_SIZE, UZH_MAT_SIZE, 1) and x.dtype == np.float32
              and y.shape == (2, UZH_MAT_SIZE, UZH_MAT_SIZE) and y.dtype == np.int32 and int(y.max()) <= 2,
              f"UZHMatData {split} batch {x.shape} {x.dtype} {y.shape} {y.dtype}")
    trainer = Trainer(get_experiment(UZH_PARITY[0]), dev, seed=0, log_dir=log_dir, tensorboard=False)
    x, y = data.train.next_batch(2)
    loss = trainer.train_step(trainer._to_device(x), trainer._to_device(y))["loss"]
    check(bool(torch.isfinite(loss)) and trainer.state.step == 1, f"UZHMatData step: loss {loss.item()}")
    trainer.close()
    log(f"[uzh] UZHMatData over a savemat file of {UZH_MAT_SLICES} slices at {UZH_MAT_SIZE}x{UZH_MAT_SIZE}: splits "
        f"{sizes}, batches (2, {UZH_MAT_SIZE}, {UZH_MAT_SIZE}, 1) float32 / (2, {UZH_MAT_SIZE}, {UZH_MAT_SIZE}) int32 "
        f"in every split, one {UZH_PARITY[0]} f32 step at batch 2: loss {loss.item():.1f}")


def uzh_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 11: the UZH prostate path (parity at 192^2, the registered
    512^2 step in each memory mode and dtype, peaks with TF32 off and on,
    the evaluation at 512^2, ``UZHMatData``)."""
    from unet_zoo_tpu_torch.data import UZHProstateData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    t0 = time.perf_counter()
    parity = {name: phiseg_parity(dev, name, size=get_experiment(name).image_size[0]) for name in UZH_PARITY}
    torch.cuda.empty_cache()

    # (b) the registered step: f32, plain, 512^2, batch 12, 3-label device augmentation
    cfg = get_experiment(UZH_EXPERIMENT)
    size, batch = cfg.image_size[0], cfg.batch_size
    arrays = synthetic.uzh_arrays(UZH_SPLITS, size, seed=0)
    data = UZHProstateData(arrays, seed=0)  # as from_config builds it: no resize_to
    zoomed = UZHProstateData(arrays, resize_to=cfg.resize_to, seed=0)
    batch_ms = {}
    for name, d in (("from_config", data), ("resize_to", zoomed)):
        t1 = time.perf_counter()
        host_batches = [d.train.next_batch(batch) for _ in range(UZH_STEPS)]
        batch_ms[name] = (time.perf_counter() - t1) / UZH_STEPS * 1e3
    plain = UZHProstateData(arrays, seed=0).train
    check(all(np.array_equal(a, b) for xy in host_batches for a, b in zip(xy, plain.next_batch(batch))),
          "resize_to at factor 1 changed a batch")
    log(f"[uzh] host time of data.train.next_batch({batch}) at {size}x{size}, 6 annotators: "
        f"{batch_ms['from_config']:.1f} ms as from_config builds the providers (no resize_to), {batch_ms['resize_to']:.1f} ms with the registry's "
        f"resize_to {cfg.resize_to} (scipy zoom at factor 1.0, the same arrays)")
    xs = [torch.from_numpy(x).to(dev) for x, _ in host_batches]
    ys = [torch.from_numpy(y).to(dev) for _, y in host_batches]
    check(set(torch.cat(ys).unique().tolist()) == {0, 1, 2}, "the batches lack a class")
    log_dir = os.path.join(log_root, "uzh")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    model = trainer.state.model
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    conv_chain.launches = 0
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    gates = zero_bias_gates(model, before, cfg, f"{UZH_EXPERIMENT} f32")
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside a step raises
    for i in range(1, UZH_STEPS):
        losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = conv_chain.launches
    check(launches == 0, f"the UZH step launched the conv-chain kernel {launches} times")
    peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    same = [n for n, b in model.named_buffers() if torch.equal(b, stats0[n])]
    check(not same, f"running statistics that did not change: {same}")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}")
    log(f"[uzh] {UZH_STEPS} registered steps ({cfg.dtype}, {cfg.effective_reversible_mode}, bs{batch} {size}x{size}, "
        f"3 classes, 6 annotators, 3-label augmentation): no host sync inside a step, {launches} conv-chain "
        f"launches, {gates['zero_biases']} BN-followed biases an exact zero, {len(stats0)} running statistics all "
        f"changed, peak {peak:.1f} MiB above what the card held before the trainer; losses "
        f"{' '.join(f'{v:.1f}' for v in losses.tolist())}")

    x, y = xs[0], ys[0]
    steps = {}
    for tf32 in (False, True):
        on = "on" if tf32 else "off"
        steps[f"plain_tf32_{on}"] = uzh_step(dev, card, log_dir, x, y, f"{UZH_EXPERIMENT} f32 plain TF32 {on}",
                                             tf32=tf32)
        steps[f"remat_tf32_{on}"] = uzh_step(dev, card, log_dir, x, y, f"{UZH_EXPERIMENT} f32 remat TF32 {on}",
                                             tf32=tf32, reversible_mode="remat")
        steps[f"reversible_tf32_{on}"] = uzh_step(dev, card, log_dir, x, y, f"{UZH_REV_EXPERIMENT} f32 TF32 {on}",
                                                  UZH_REV_EXPERIMENT, tf32=tf32)
    steps["bf16"] = uzh_step(dev, card, log_dir, x, y, f"{UZH_EXPERIMENT} bf16 plain", dtype="bfloat16")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for on in ("off", "on"):
        plain = steps[f"plain_tf32_{on}"]["peak_mib"]
        log(f"[memory] {UZH_EXPERIMENT} f32 bs{batch} {size}x{size}, TF32 {on}: step peak above the card's other state "
            f"plain {plain:.1f} / remat {steps[f'remat_tf32_{on}']['peak_mib']:.1f} / reversible "
            f"{steps[f'reversible_tf32_{on}']['peak_mib']:.1f} MiB, saving against plain remat "
            f"{1 - steps[f'remat_tf32_{on}']['peak_mib'] / plain:.1%}, reversible "
            f"{1 - steps[f'reversible_tf32_{on}']['peak_mib'] / plain:.1%}; the card's "
            f"{torch.cuda.get_device_properties(dev).total_memory / MIB:.0f} MiB | card: {card}")
    del xs, ys
    torch.cuda.empty_cache()

    # (d) the evaluation at 512^2 on the registered trainer; (e) UZHMatData
    evaluation = uzh_validation(trainer, data, dev, card)
    trainer.close()
    del trainer, model
    torch.cuda.empty_cache()
    uzh_mat(dev, os.path.join(log_root, "uzh_mat"))
    took = time.perf_counter() - t0
    log(f"[uzh] phase 11 took {took:.1f} s")
    return {"parity": parity, "launches": launches, "registered_peak_mib": peak, "steps": steps,
            "next_batch_ms": batch_ms, "evaluation": evaluation, "seconds": took}


def dp_deterministic():
    """cuDNN deterministic and ``deterministic_resize`` (whose backward has no
    atomics): two runs of a step then agree bit for bit."""
    stack = contextlib.ExitStack()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    stack.callback(setattr, torch.backends.cudnn, "deterministic", deterministic)
    stack.enter_context(deterministic_resize())
    return stack


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def own_draws_step(tr, x: torch.Tensor, y: torch.Tensor) -> dict:
    """The plain step of (a): one step of ``tr`` on the whole batch in which
    the model draws its own z noise from the state's generator inside the
    forward, not the Trainer's ``train_noise`` before it (what a
    one-process step computed before data parallelism). Returns the aux
    dict."""
    from unet_zoo_tpu_torch.training.trainer import LATENT_FAMILIES

    x, y = tr.augment(x, y)
    model = tr.state.model
    model.train()
    loss, aux = model.loss(model(x, y, generator=tr.state.generator) if tr.cfg.model in LATENT_FAMILIES else
                           model(x), y)
    tr.backward(loss)
    tr.update(loss)
    return {k: v.detach() for k, v in aux.items()}


def dp_world1(conv_chain, dev, card: str, log_dir: str) -> dict:
    """(a): a one-process NCCL group through ``parallel.init_distributed`` and
    ``make_mesh``: the bf16 ``unet`` step at bs64 and ``phiseg_7_5_12`` at
    bs12 with device augmentation, DP_STEPS steps from seed 0 by the mesh's
    Trainer and by the plain step (``own_draws_step``) of a Trainer without
    a mesh, each bit-identical (losses, parameters, running statistics,
    Adam's moments, scheduler, generator; cuDNN deterministic and the resize
    as matrix products on both sides); the launches of each mesh step (21 a
    U-Net step, none in PHiSeg), no host sync inside a step after the first,
    and ms a step on both, in turns."""
    import torch.distributed as dist

    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh
    from unet_zoo_tpu_torch.training import Trainer

    check(init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"), "no process group")
    result = {}
    try:
        check(dist.get_backend() == "nccl", f"a one-card group runs {dist.get_backend()}")
        mesh = make_mesh()
        check(mesh.device == dev and mesh.world == 1, f"mesh {mesh}")
        for name, batch, per_step in (("unet", TRAIN_BATCH, len(BLOCKS) * STAGES_PER_BLOCK),
                                      (PHISEG_EXPERIMENT, DP_PHISEG_BATCH, 0)):
            cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16", batch_size=batch)
            xs, ys = train_batches(DP_STEPS, dev, batch)
            trainers, steps, losses, launches = {}, {}, {}, []
            with dp_deterministic():
                for label in ("plain", "mesh"):
                    tr = Trainer(cfg, seed=0, log_dir=log_dir, **({"mesh": mesh} if label == "mesh" else
                                                                   {"device": dev}))
                    trainers[label], losses[label] = tr, []
                    step = tr.train_step if label == "mesh" else functools.partial(own_draws_step, tr)
                    steps[label] = step
                    for i in range(DP_STEPS):
                        torch.cuda.synchronize()
                        conv_chain.launches = 0
                        torch.cuda.set_sync_debug_mode("error" if i else 0)
                        try:
                            losses[label].append(step(xs[i], ys[i])["loss"])
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                        torch.cuda.synchronize()
                        if label == "mesh":
                            launches.append(conv_chain.launches)
            check(launches == [per_step] * DP_STEPS, f"{name} mesh steps launched {launches}, expected {per_step} each")
            check(torch.equal(torch.stack(losses["plain"]), torch.stack(losses["mesh"])),
                  f"{name}: mesh losses {losses['mesh']} vs plain {losses['plain']}")
            same_state(trainers["plain"].state.state_dict(), trainers["mesh"].state.state_dict(), f"{name} state")
            ms = {"plain": math.inf, "mesh": math.inf}
            for label in ("plain", "mesh", "mesh", "plain"):
                step = steps[label]
                ms[label] = min(ms[label], cuda_ms(lambda: step(xs[0], ys[0]), DP_TIME_STEPS))
            log(f"[dp] (a) {name} bf16 bs{batch}, one-process NCCL mesh vs the plain step (the model's own z draws), "
                f"{DP_STEPS} steps from seed 0 with device augmentation: losses, parameters, running statistics, "
                f"Adam's moments, scheduler and generator bit-identical; {launches} conv-chain launches a mesh step; no host sync inside steps "
                f"2-{DP_STEPS}; ms a step mesh {ms['mesh']:.3f}, plain {ms['plain']:.3f} (min of 2 rounds of "
                f"{DP_TIME_STEPS}, in turns) | card: {card}")
            result[name] = {"launches": launches, "ms": ms["mesh"], "plain_ms": ms["plain"]}
            del trainers, steps
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return result


def dp_worker(rank: int, port: int, workdir: str) -> None:
    """One of DP_RANKS processes of (b) and (c), on the one card over gloo
    (``chip_smoke.py --dp-worker RANK PORT WORKDIR``): writes
    ``WORKDIR/<path>_<rank>.pt`` for the parent to check."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from unet_zoo_tpu_torch.data import LIDCData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.parallel import batch_spec, init_distributed, make_mesh
    from unet_zoo_tpu_torch.training import Trainer, save_checkpoint
    from unet_zoo_tpu_torch.training import trainer as trainer_module

    check(init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda", backend="gloo"), "no process group")
    check(dist.get_backend() == "gloo", f"two processes on one card run {dist.get_backend()}")
    mesh = make_mesh()
    dev = mesh.device

    # (b): PHiSeg as registered (f32, TF32 off) and the f32 U-Net, each step saved
    for name, path_cfg in ((PHISEG_EXPERIMENT, {"batch_size": DP_PHISEG_BATCH}),
                           ("unet", {"batch_size": TRAIN_BATCH, "dtype": "float32"})):
        cfg = dataclasses.replace(get_experiment(name), **path_cfg)
        xs, ys = train_batches(DP_RANK_STEPS, dev, cfg.batch_size)
        rows = batch_spec(mesh, cfg.batch_size)
        tr = Trainer(cfg, seed=0, log_dir=os.path.join(workdir, f"log{rank}"), mesh=mesh)
        steps = []
        for i in range(DP_RANK_STEPS):
            torch.cuda.synchronize()
            conv_chain.launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            aux = tr.train_step(xs[i][rows], ys[i][rows])
            end.record()
            end.synchronize()
            steps.append({"loss": aux["loss"].item(), "ms": start.elapsed_time(end), "launches": conv_chain.launches,
                          "grads": {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()},
                          "state": copy.deepcopy(tr.state.state_dict())})
            if rank == 0:
                save_checkpoint(os.path.join(workdir, f"{name}.{i}.pt"), tr.state)
        torch.save(steps, os.path.join(workdir, f"{name}_{rank}.pt"))
        del tr
        torch.cuda.empty_cache()

    # (c): Trainer.train with validations, every checkpoint write recorded
    cfg = dp_train_config()
    data = LIDCData(synthetic.lidc_splits(HARNESS_SPLITS, IMAGE, seed=0), seed=0)
    writes, save = [], trainer_module.save_checkpoint
    with mock.patch.object(trainer_module, "save_checkpoint", lambda path, st: (writes.append(path), save(path, st))):
        tr = Trainer(cfg, seed=0, log_dir=os.path.join(workdir, f"train{rank}"), mesh=mesh)
        t0 = time.perf_counter()
        tr.train(data)
        train_s = time.perf_counter() - t0
        tr.close()
    torch.save({"state": copy.deepcopy(tr.state.state_dict()), "writes": [os.path.basename(w) for w in writes],
                "train_s": train_s}, os.path.join(workdir, f"train_{rank}.pt"))
    dist.destroy_process_group()
    log(f"DP_DONE {rank}")


def dp_train_config():
    from unet_zoo_tpu_torch.experiments import get_experiment

    return dataclasses.replace(get_experiment("unet"), dtype="bfloat16", iterations=HARNESS_ITERATIONS,
                               validation_frequency=HARNESS_VALIDATION_FREQUENCY,
                               logging_frequency=HARNESS_VALIDATION_FREQUENCY,
                               num_validation_images=HARNESS_SPLITS[1], validation_samples=HARNESS_VALIDATION_SAMPLES)


def params_within(got: dict, want: dict, grads: dict, lr: float, label: str) -> int:
    """Every parameter of ``got`` within DP_PARAM_ATOL_LR lr of ``want`` but
    entries whose gradient (``grads``, the reference's) is rounding, flipped
    by Adam's first update, at most ROUNDING_FLIP_LR lr away; returns how many."""
    flipped = 0
    for n, g in grads.items():
        diff = (got[n].float() - want[n].float()).abs().cpu()
        g = g.abs().cpu()
        off = diff > DP_PARAM_ATOL_LR * lr
        wrong = off & (g > ROUNDING_OF_MAX * g.max())
        if bool(wrong.any()):
            check(False, f"{label} {n}: {diff[wrong].max().item() / lr:.3f} lr off where the gradient is not rounding")
        check(diff.max().item() <= ROUNDING_FLIP_LR * lr, f"{label} {n}: {diff.max().item() / lr:.3f} lr off")
        flipped += int(off.sum())
    return flipped


def dp_ranks(conv_chain, dev, card: str, log_root: str) -> dict:
    """(b) and (c): DP_RANKS processes on the one card over gloo (NCCL takes
    one process a card), started together with a time limit; the parent
    then holds what they wrote against the one-process runs, each (b) step
    from the two processes' state before it (their checkpoint)."""
    from unet_zoo_tpu_torch.data import LIDCData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer, restore_checkpoint

    workdir = os.path.join(log_root, "dp")
    os.makedirs(workdir)
    port = free_port()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", str(r), str(port), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(DP_RANKS)]
    try:
        outs = [p.communicate(timeout=DP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-40:])
        check(p.returncode == 0 and f"DP_DONE {r}" in out, f"dp process {r} exited {p.returncode}:\n{tail}")
    log(f"[dp] {DP_RANKS} processes on one card over gloo ran (b) and (c) in {spawn_s:.1f} s | card: {card}")
    result = {"spawn_s": spawn_s}

    # (b): the processes agree bit for bit; each step against one process from the same state
    for name, path_cfg in ((PHISEG_EXPERIMENT, {"batch_size": DP_PHISEG_BATCH}),
                           ("unet", {"batch_size": TRAIN_BATCH, "dtype": "float32"})):
        ranks = [torch.load(os.path.join(workdir, f"{name}_{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
        cfg = dataclasses.replace(get_experiment(name), **path_cfg)
        xs, ys = train_batches(DP_RANK_STEPS, dev, cfg.batch_size)
        one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
        lr = cfg.learning_rate
        rows = []
        for i in range(DP_RANK_STEPS):
            for r in range(1, DP_RANKS):
                same_state(ranks[0][i]["state"], ranks[r][i]["state"], f"{name} step {i + 1} process {r}")
            if i:
                restore_checkpoint(os.path.join(workdir, f"{name}.{i - 1}.pt"), one.state)
            aux = one.train_step(xs[i], ys[i])
            got = ranks[0][i]
            want_state = one.state.state_dict()["model"]
            grads = {n: p.grad for n, p in one.state.model.named_parameters()}
            loss_rel = abs(got["loss"] - aux["loss"].item()) / abs(aux["loss"].item())
            g = torch.cat([got["grads"][n].reshape(-1).double() for n in grads]).to(dev)
            w = torch.cat([grads[n].reshape(-1).double() for n in grads])
            grad_l2 = ((g - w).norm() / w.norm()).item()
            mine = one.state.state_dict()
            for k in ("generator", "step"):  # the global batch's draws; sched.best is the loss, within its gate
                same_state(mine[k], got["state"][k], f"{name} step {i + 1} {k}")
            for k in ("lr", "num_bad"):
                same_state(mine["sched"][k], got["state"]["sched"][k], f"{name} step {i + 1} sched.{k}")
            if name == "unet":
                check(all(ranks[r][i]["launches"] == len(BLOCKS) * STAGES_PER_BLOCK for r in range(DP_RANKS)),
                      f"f32 unet step {i + 1}: launches {[ranks[r][i]['launches'] for r in range(DP_RANKS)]}")
                check(loss_rel <= PHISEG_LOSS_RTOL and grad_l2 <= DP_F32_GRAD_L2,
                      f"f32 unet step {i + 1}: loss rel {loss_rel:.3e}, gradient rel L2 {grad_l2:.3e}")
                flipped = params_within(got["state"]["model"], want_state, grads, lr, f"f32 unet step {i + 1}")
                check(flipped <= FLIP_SHARE * w.numel(), f"f32 unet step {i + 1}: {flipped} entries flipped")
                extra = f"{flipped} of {w.numel()} parameter entries flipped by Adam's first update (tol " \
                        f"{FLIP_SHARE:.0e} of them), the rest within {DP_PARAM_ATOL_LR} lr"
            else:
                stats = max(((got["state"]["model"][k].float() - v.float()).abs().max() / v.abs().max()).item()
                            for k, v in want_state.items() if "running" in k)
                check(loss_rel <= PHISEG_LOSS_RTOL and grad_l2 <= PHISEG_TRAIN_GRAD_L2 and stats <= PHISEG_STATS_RTOL,
                      f"{name} step {i + 1}: loss rel {loss_rel:.3e}, gradient rel L2 {grad_l2:.3e}, running "
                      f"statistics {stats:.3e} of their max")
                extra = f"running statistics {stats:.3e} of their max (tol {PHISEG_STATS_RTOL})"
            ms = [ranks[r][i]["ms"] for r in range(DP_RANKS)]
            log(f"[dp] (b) {name} f32 (TF32 off) global bs{cfg.batch_size}, {DP_RANKS} processes vs one from the "
                f"same state, step {i + 1}: processes bit-identical; loss rel {loss_rel:.3e} (tol {PHISEG_LOSS_RTOL}), "
                f"gradient rel L2 {grad_l2:.3e} (tol {DP_F32_GRAD_L2 if name == 'unet' else PHISEG_TRAIN_GRAD_L2}); "
                f"{extra}; launches a process {[ranks[r][i]['launches'] for r in range(DP_RANKS)]}; ms a step a "
                f"process {', '.join(f'{m:.3f}' for m in ms)} (gloo through the host; for information) | card: {card}")
            rows.append({"loss_rel": loss_rel, "grad_rel_l2": grad_l2, "ms": ms,
                         "launches": [ranks[r][i]["launches"] for r in range(DP_RANKS)]})
        result[name] = rows
        del one
        torch.cuda.empty_cache()

    # (c): process 0 alone validated and wrote; the final state against one process's run
    ranks = [torch.load(os.path.join(workdir, f"train_{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
    same_state(ranks[0]["state"], ranks[1]["state"], "train() process 1")
    validations = HARNESS_ITERATIONS // HARNESS_VALIDATION_FREQUENCY
    writes = ranks[0]["writes"]
    check(writes.count("validation_ckpt") == validations and all(w.startswith(("validation_ckpt", "best_"))
                                                                 for w in writes),
          f"process 0 wrote {writes}")
    check(not ranks[1]["writes"] and not os.path.exists(os.path.join(workdir, "train1")),
          f"process 1 wrote {ranks[1]['writes']}")
    log_dir = os.path.join(workdir, "train0")
    with open(os.path.join(log_dir, "metrics_validation.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(log_dir, "metrics_train.jsonl")) as f:
        train_records = [json.loads(line) for line in f]
    steps = [HARNESS_VALIDATION_FREQUENCY * (i + 1) for i in range(validations)]
    check([r["step"] for r in records] == steps and [r["step"] for r in train_records] == steps,
          f"metrics records: validation {records}, train {train_records}")
    data = LIDCData(synthetic.lidc_splits(HARNESS_SPLITS, IMAGE, seed=0), seed=0)
    one = Trainer(dp_train_config(), dev, seed=0, log_dir=os.path.join(workdir, "train_one"))
    start = {n: p.detach().clone() for n, p in one.state.model.named_parameters()}
    t0 = time.perf_counter()
    one.train(data)
    one_s = time.perf_counter() - t0
    one.close()
    got = ranks[0]["state"]["model"]
    moved = math.sqrt(sum((p.detach() - start[n]).double().square().sum().item()
                          for n, p in one.state.model.named_parameters()))
    apart = math.sqrt(sum((got[n].to(dev) - p.detach()).double().square().sum().item()
                          for n, p in one.state.model.named_parameters()))
    worst = max((got[n].to(dev) - p.detach()).abs().max().item() for n, p in one.state.model.named_parameters())
    check(apart <= DP_TRAIN_REL_MOVE * moved, f"train(): {DP_RANKS} processes end {apart:.4e} from one process's "
          f"parameters, which moved {moved:.4e}")
    log(f"[dp] (c) Trainer.train({HARNESS_ITERATIONS}) bf16 unet bs{TRAIN_BATCH} on {DP_RANKS} processes, a "
        f"validation every {HARNESS_VALIDATION_FREQUENCY} on process 0 alone: processes bit-identical; process 0 wrote "
        f"{writes} and one metrics record a validation and a log step, process 1 nothing (no log directory); final "
        f"parameters {apart:.4e} from one process's run (L2), which moved them {moved:.4e} (tol "
        f"{DP_TRAIN_REL_MOVE} of it), worst entry {worst / dp_train_config().learning_rate:.3f} lr; train() "
        f"{ranks[0]['train_s']:.2f} s on {DP_RANKS} processes, {one_s:.2f} s on one | card: {card}")
    result["train"] = {"apart_of_moved": apart / moved, "writes": writes, "train_s": ranks[0]["train_s"],
                       "one_train_s": one_s}
    return result


def dp_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 12: data parallelism."""
    t0 = time.perf_counter()
    world1 = dp_world1(conv_chain, dev, card, log_root)
    torch.cuda.empty_cache()
    ranks = dp_ranks(conv_chain, dev, card, log_root)
    log(f"[dp] phase 12 took {time.perf_counter() - t0:.1f} s | card: {card}")
    return {"world1": world1, "ranks": ranks}


def halo_tile_blocks(conv_chain, dev, card: str) -> dict:
    """Phase 14's halo tiles: each BN-free block at TRAIN_BATCH in bf16 run
    as the space path runs it on SPACE_RANKS processes, stage by stage on
    tiles of h + 2 rows of the zero-padded stage input (what a halo exchange
    gives), each cropped of its two edge rows and stitched, against the
    unsplit kernel on the whole image (bit for bit, or max|diff|) and the
    plain version at phase 2's gate."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(14)
    rows, identical, worst = [], True, 0.0
    for block, size, ci, co in BLOCKS:
        x = torch.randn((TRAIN_BATCH, size, size, ci), generator=gen).to(dev, torch.bfloat16)
        ks, bs = chain_weights([(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1), gen, dev)
        whole = conv_chain.fused_conv_chain(x, ks, bs)
        ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
        h = size // SPACE_RANKS
        y = x
        for k, b in zip(ks, bs):
            padded = F.pad(y, (0, 0, 0, 0, 1, 1))
            y = torch.cat([conv_chain.fused_conv_chain(padded[:, r * h:r * h + h + 2].contiguous(), [k], [b])[:, 1:-1]
                           for r in range(SPACE_RANKS)], dim=1)
        torch.cuda.synchronize()
        same = torch.equal(y, whole)
        diff = (y.float() - whole.float()).abs().max().item()
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = BF16_ULPS * bf16_ulp(scale)
        log(f"[space] halo tiles {block} ({TRAIN_BATCH}, {size}, {size}, {ci})->{co} bf16 on {SPACE_RANKS} tiles of "
            f"{h}+2 rows: {'bit-identical to' if same else f'max|diff| {diff:.3e} from'} the unsplit kernel; "
            f"plain version max|diff| {err:.3e} (tol {tol:.3e})")
        check(err <= tol and diff <= tol, f"halo tiles {block}: {err} from the plain version, {diff} from the kernel")
        identical &= same
        worst = max(worst, err)
        rows.append({"block": block, "bit_identical": same, "max_abs_err": err, "vs_unsplit": diff})
    log(f"[space] halo tiles: the {len(BLOCKS)} blocks {'bit-identical to' if identical else 'within the gate of'} "
        f"the unsplit kernel | card: {card}")
    return {"bit_identical": identical, "max_abs_err": worst, "rows": rows}


def space_batch(dev, batch: int, size: int, classes: int, seed: int):
    """A batch of (batch, size, size, 1) noise from a fixed seed, labelled
    in ``classes`` bands of a 9x9 box blur of it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, 1, size, size), generator=gen, device=dev)
    blur = torch.nn.functional.avg_pool2d(x, 9, 1, 4)
    edges = torch.linspace(-0.1, 0.1, classes - 1, device=dev) if classes > 2 else torch.zeros(1, device=dev)
    return x.view(batch, size, size, 1), torch.bucketize(blur, edges).view(batch, size, size)


def graph_mib(tr, x, y) -> float:
    """MiB that one train-mode forward and loss of ``tr`` leave allocated
    (the autograd graph's saved tensors: the step's activation memory,
    without the backward's and cuDNN's transient workspace), inside
    ``space_sharding`` as the step runs them; no backward follows."""
    from unet_zoo_tpu_torch.parallel.space import space_sharding

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with space_sharding(tr.mesh):
        xa, ya = tr.augment(x, y)
        loss, _ = tr.forward_loss(xa, ya)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del loss, xa, ya
    return held / MIB


def space_worker(rank: int, port: int, workdir: str, world: int = SPACE_RANKS, backend: str = "gloo") -> None:
    """One of ``world`` processes of phase 14 on a mesh of space
    SPACE_RANKS (``chip_smoke.py --space-worker RANK PORT WORKDIR [WORLD
    BACKEND]``): by default SPACE_RANKS processes on the one card over gloo,
    each within SPACE_MEMORY_FRACTION of it; with WORLD 4 and nccl one
    process a card, data 2 (``tools/torch_space_nccl.py``). Each step takes
    this process's data group's images of the global batch. Writes
    ``WORKDIR/space_<rank>.pt`` for the parent to check."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from unet_zoo_tpu_torch.data.augment import AugmentOptions
    from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh, replicated, shard_batch
    from unet_zoo_tpu_torch.training import Trainer

    check(init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda", backend=backend), "no process group")
    check(dist.get_backend() == backend, f"the group runs {dist.get_backend()}")
    mesh = make_mesh(space=SPACE_RANKS)
    dev = mesh.device
    check((mesh.data, mesh.space) == (world // SPACE_RANKS, SPACE_RANKS), f"mesh {mesh}")
    if world > torch.cuda.device_count():
        torch.cuda.set_per_process_memory_fraction(SPACE_MEMORY_FRACTION, dev)
    log(f"[space worker {rank}] {backend} mesh {mesh.data}x{mesh.space} on {dev}")
    log_dir = os.path.join(workdir, f"log{rank}")
    out = {}

    def timed_step(tr, x, y):
        torch.cuda.synchronize()
        conv_chain.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aux = tr.train_step(shard_batch(mesh, x), shard_batch(mesh, y))
        end.record()
        end.synchronize()
        check(replicated(mesh, [*tr.state.model.parameters(), *tr.state.model.buffers()]),
              f"process {rank}: the processes' states differ after a step")
        return {"loss": aux["loss"].item(), "ms": start.elapsed_time(end), "launches": conv_chain.launches}

    # (a): the bf16 U-Net at bs64, 128x128
    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=TRAIN_BATCH)
    xs, ys = train_batches(SPACE_UNET_STEPS, dev)
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["unet"] = []
    for i in range(SPACE_UNET_STEPS):
        out["unet"].append(timed_step(tr, xs[i], ys[i]))
        if i == 0:
            out["unet_grads"] = {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()}
    del tr
    torch.cuda.empty_cache()
    log(f"[space worker {rank}] (a) {out['unet']}")

    # (b): the registered UZH step, f32 with TF32 off, bs12, 512x512
    cfg = get_experiment(UZH_EXPERIMENT)
    x, y = space_batch(dev, cfg.batch_size, cfg.image_size[0], cfg.n_classes, seed=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["uzh"] = timed_step(tr, x, y)
    out["uzh"]["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    out["uzh_grads"] = {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()}
    out["uzh_state"] = {k: v.cpu() for k, v in tr.state.model.state_dict().items() if "running" in k}
    tr.state.optimizer.zero_grad(set_to_none=True)
    out["uzh"]["graph_mib"] = graph_mib(tr, shard_batch(mesh, x), shard_batch(mesh, y))
    del tr
    torch.cuda.empty_cache()
    log(f"[space worker {rank}] (b) {out['uzh']}")

    # (c): the twin of dryrun_multichip
    cfg = ExperimentConfig(experiment_name="dryrun", model="phiseg", filter_channels=SPACE_DRYRUN_FILTERS,
                           latent_levels=5, n_classes=2, batch_size=2, image_size=(SPACE_DRYRUN_SIZE,) * 2,
                           augmentation_options=AugmentOptions(do_rotations=True, do_fliplr=True, augment_every_nth=2,
                                                               nlabels=2))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, SPACE_DRYRUN_SIZE, SPACE_DRYRUN_SIZE, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (2, SPACE_DRYRUN_SIZE, SPACE_DRYRUN_SIZE)))
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["dryrun"] = [timed_step(tr, x.to(dev), y.to(dev)) for _ in range(2)]
    cfg3d = ExperimentConfig(experiment_name="dryrun3d", model="phiseg3d", data_loader="brats", batch_size=2,
                             **SPACE_DRYRUN_3D)
    x3 = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 4)).astype(np.float32))
    y3 = torch.from_numpy((rng.random((2, 16, 16, 16, 3)) > 0.5).astype(np.float32))
    tr = Trainer(cfg3d, seed=0, log_dir=log_dir, mesh=mesh)
    out["dryrun3d"] = timed_step(tr, x3.to(dev), y3.to(dev))
    torch.save(out, os.path.join(workdir, f"space_{rank}.pt"))
    dist.destroy_process_group()
    log(f"SPACE_DONE {rank}")


def grads_apart(got: dict, want: dict) -> tuple:
    """(the whole gradient's relative L2 distance, the worst tensor's
    max|diff| over its max|want|)."""
    g = torch.cat([got[n].reshape(-1).double().cpu() for n in want])
    w = torch.cat([want[n].reshape(-1).double().cpu() for n in want])
    worst = max(((got[n].float().cpu() - v.float().cpu()).abs().max() / v.float().abs().max().clamp_min(1e-30)).item()
                for n, v in want.items())
    return ((g - w).norm() / w.norm()).item(), worst


def spawn_space(workdir: str, world: int = SPACE_RANKS, backend: str = "gloo", timeout: float = SPACE_TIMEOUT) -> tuple:
    """Starts ``world`` phase-14 processes (``space_worker``) together,
    each writing its output to ``WORKDIR/worker_<rank>.log``, and waits for
    them within ``timeout`` seconds in all (then kills them); returns (what
    each wrote, seconds)."""
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"worker_{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--space-worker", str(r), str(port),
                               workdir, str(world), backend], stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    spawn_s = time.perf_counter() - t0
    outs = [open(os.path.join(workdir, f"worker_{r}.log")).read() for r in range(world)]
    failed = [(r, p.returncode, "\n".join(out.splitlines()[-40:])) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0 or f"SPACE_DONE {r}" not in out]
    check(not failed, "".join(f"space process {r} exited {rc}:\n{tail}\n" for r, rc, tail in failed))
    return [torch.load(os.path.join(workdir, f"space_{r}.pt"), weights_only=False) for r in range(world)], spawn_s


def space_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 14: spatial sharding."""
    t0 = time.perf_counter()
    tiles = halo_tile_blocks(conv_chain, dev, card)
    workdir = os.path.join(log_root, "space")
    os.makedirs(workdir)
    torch.cuda.empty_cache()
    ranks, spawn_s = spawn_space(workdir)
    mesh = f"{SPACE_RANKS} processes sharing the card over gloo, each within {SPACE_MEMORY_FRACTION} of it"
    log(f"[space] {mesh} (one data group, the height split in {SPACE_RANKS}) ran (a)-(c) in {spawn_s:.1f} s | "
        f"card: {card}")
    result = {"tiles": tiles, "spawn_s": spawn_s,
              **space_checks(conv_chain, dev, card, ranks, workdir, mesh, SPACE_MEMORY_FRACTION)}
    result["seconds"] = time.perf_counter() - t0
    log(f"[space] phase 14 took {result['seconds']:.1f} s | card: {card}")
    return result


def shared_peak(dev, card: str, cfg, x, y, share: float, workdir: str):
    """The peak MiB of one process's step of ``cfg`` within ``share`` of the
    card, the share each space process had (cuDNN then takes the plans
    whose workspace fits), or None where it runs out of memory."""
    from unet_zoo_tpu_torch.training import Trainer

    torch.cuda.set_per_process_memory_fraction(share, dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    peak = None
    try:
        one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
        one.train_step(x, y)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    except torch.OutOfMemoryError:
        pass
    finally:
        one = None
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    log(f"[space] (b) one process within {share} of the card, as each space process: "
        f"{'out of memory' if peak is None else f'peak {peak:.1f} MiB'} | card: {card}")
    return peak


def space_checks(conv_chain, dev, card: str, ranks: list, workdir: str, mesh: str, share=None) -> dict:
    """Phase 14 (a)-(c) from what the processes of ``mesh`` (its
    description) wrote (``ranks``): the global batch's one-process steps on
    ``dev`` from the same state and draws, and the gates; with ``share``
    (each process's share of the card), also one process's UZH step within
    that share (``shared_peak``)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    result = {}
    per_step = len(BLOCKS) * STAGES_PER_BLOCK

    # (a): the bf16 U-Net against one process from the same state and draws
    launches = [[s["launches"] for s in r["unet"]] for r in ranks]
    check(all(n == per_step for row in launches for n in row), f"space unet launches a process {launches}")
    check(all(r["unet"][i]["loss"] == ranks[0]["unet"][i]["loss"] for r in ranks for i in range(SPACE_UNET_STEPS)),
          "the processes' losses differ")
    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=TRAIN_BATCH)
    xs, ys = train_batches(1, dev)
    one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
    torch.cuda.synchronize()
    conv_chain.launches = 0
    loss = one.train_step(xs[0], ys[0])["loss"].item()
    torch.cuda.synchronize()
    check(conv_chain.launches == per_step, f"one-process unet step launched {conv_chain.launches}")
    grads = {n: p.grad for n, p in one.state.model.named_parameters()}
    got = ranks[0]
    loss_rel = abs(got["unet"][0]["loss"] - loss) / abs(loss)
    l2, worst = grads_apart(got["unet_grads"], grads)
    ms = [[s["ms"] for s in r["unet"]] for r in ranks]
    log(f"[space] (a) unet bf16 bs{TRAIN_BATCH} {IMAGE}x{IMAGE} at space {SPACE_RANKS}, {mesh}: {launches} conv-chain launches "
        f"a step a process (halo tiles); step 1 against one process from the same state and draws: loss rel "
        f"{loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}), gradient rel L2 {l2:.3e}, worst tensor max|diff| {worst:.3e} of its "
        f"max (tol {TRAIN_GRAD_RTOL_OF_MAX}); ms a step a process {ms} | "
        f"card: {card}")
    check(loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL_OF_MAX,
          f"space unet: loss rel {loss_rel}, gradient worst {worst}")
    result["unet"] = {"launches": launches, "loss_rel": loss_rel, "grad_rel_l2": l2, "grad_worst_of_max": worst,
                      "ms": ms}
    del one, grads
    torch.cuda.empty_cache()

    # (b): the registered UZH step against one process, and the peaks
    cfg = get_experiment(UZH_EXPERIMENT)
    x, y = space_batch(dev, cfg.batch_size, cfg.image_size[0], cfg.n_classes, seed=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss = one.train_step(x, y)["loss"].item()
    ev[1].record()
    torch.cuda.synchronize()
    one_ms = ev[0].elapsed_time(ev[1])
    one_peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    grads = {n: p.grad.clone() for n, p in one.state.model.named_parameters()}
    want_stats = {k: v.clone() for k, v in one.state.model.state_dict().items() if "running" in k}
    one.state.optimizer.zero_grad(set_to_none=True)
    one_graph = graph_mib(one, x, y)
    graphs = [r["uzh"]["graph_mib"] for r in ranks]
    loss_rel = abs(got["uzh"]["loss"] - loss) / abs(loss)
    l2, _ = grads_apart(got["uzh_grads"], grads)
    stats = max(((got["uzh_state"][k].to(dev) - v).abs().max() / v.abs().max()).item() for k, v in want_stats.items())
    peaks = [r["uzh"]["peak_mib"] for r in ranks]
    step_ms = [r["uzh"]["ms"] for r in ranks]
    log(f"[space] (b) {UZH_EXPERIMENT} f32 (TF32 off) bs{cfg.batch_size} {cfg.image_size[0]}x{cfg.image_size[1]} at "
        f"space {SPACE_RANKS}, {mesh}, against one process alone on a card from the same state and draws: loss rel "
        f"{loss_rel:.3e} (tol {PHISEG_LOSS_RTOL}), gradient rel L2 "
        f"{l2:.3e} (tol {PHISEG_TRAIN_GRAD_L2}), running statistics {stats:.3e} of their max (tol {PHISEG_STATS_RTOL}); "
        f"peak MiB a process {', '.join(f'{p:.1f}' for p in peaks)} against {one_peak:.1f} for one process "
        f"({SPACE_UZH_ONE_PEAK_MIB} recorded by phase 11); a forward's graph holds {', '.join(f'{g:.1f}' for g in graphs)} "
        f"MiB a process against {one_graph:.1f}; ms a step a process "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}, one process {one_ms:.1f} | card: {card}")
    check(loss_rel <= PHISEG_LOSS_RTOL and l2 <= PHISEG_TRAIN_GRAD_L2 and stats <= PHISEG_STATS_RTOL,
          f"space uzh: loss rel {loss_rel}, gradient rel L2 {l2}, statistics {stats}")
    del one, grads
    torch.cuda.empty_cache()
    # within a share of the card cuDNN's workspace fills what the share
    # leaves, so a peak is held against one process within the same share
    one_shared = None if share is None else shared_peak(dev, card, cfg, x, y, share, workdir)
    check(max(peaks) < one_peak, f"space uzh: a process peaked {max(peaks):.1f} MiB, one process {one_peak:.1f}")
    check(one_shared is None or max(peaks) < one_shared,
          f"space uzh: a process peaked {max(peaks):.1f} MiB, one process within the same share {one_shared:.1f}")
    check(max(graphs) <= SPACE_GRAPH_SHARE * one_graph,
          f"space uzh: a process's graph holds {max(graphs):.1f} MiB, over {SPACE_GRAPH_SHARE} of one process's "
          f"{one_graph:.1f}")
    result["uzh"] = {"loss_rel": loss_rel, "grad_rel_l2": l2, "stats_of_max": stats, "peak_mib": peaks,
                     "one_peak_mib": one_peak, "one_shared_peak_mib": one_shared, "graph_mib": graphs,
                     "one_graph_mib": one_graph, "ms": step_ms, "one_ms": one_ms,
                     "launches": [r["uzh"]["launches"] for r in ranks]}

    # (c): the dryrun_multichip twin
    losses = [[s["loss"] for s in r["dryrun"]] + [r["dryrun3d"]["loss"]] for r in ranks]
    check(all(math.isfinite(v) for row in losses for v in row), f"dryrun losses {losses}")
    log(f"[space] (c) dryrun_multichip twin at space {SPACE_RANKS}, {mesh}: phiseg filters {SPACE_DRYRUN_FILTERS} "
        f"{SPACE_DRYRUN_SIZE}x{SPACE_DRYRUN_SIZE} bs2, losses {losses[0][:2]}; phiseg3d 16^3 bs2 loss "
        f"{losses[0][2]:.4f}: finite | card: {card}")
    result["dryrun_losses"] = losses[0]
    return result


def cli_file(workdir: str, run: str, name: str, changes: dict, iterations: int) -> str:
    """An experiment file taking the registered ``name`` with a validation at
    ``iterations`` on CLI_VALIDATION_IMAGES images and ``changes``."""
    path = os.path.join(workdir, f"{run}.py")
    changes = dict(validation_frequency=iterations, num_validation_images=CLI_VALIDATION_IMAGES, logging_frequency=1,
                   **changes)
    with open(path, "w") as f:
        f.write("import dataclasses\n\nfrom unet_zoo_tpu_torch.experiments import get_experiment\n\n"
                f"config = dataclasses.replace(get_experiment({name!r}), **{changes!r})\n")
    return path


def check_run_files(run: str, cfg, log_dir: str, n_eval: int) -> dict:
    """The files of a train and an eval --generate-images run: the
    provenance, the checkpoints, the test sweep's npz with its schema and
    finite values, and the PNGs (GENERATED images x (image, ground truth,
    samples)), each decoding to the model's (H, W)."""
    from unet_zoo_tpu_torch.utils.png import read_png

    files = sorted(os.listdir(log_dir))
    needed = ["experiment.json", f"{run}.py", "last", "validation_ckpt", "best_metrics.json", "metrics_train.jsonl",
              "metrics_validation.jsonl", "run.log", "samples"]
    check(all(f in files for f in needed) and any(f.startswith("best_") and f != "best_metrics.json" for f in files),
          f"{run}: files {files}")
    with open(os.path.join(log_dir, "experiment.json")) as f:
        check(json.load(f)["experiment_name"] == cfg.experiment_name, f"{run}: experiment.json")
    brats = cfg.is_3d
    with np.load(os.path.join(log_dir, "brats_test_results.npz" if brats else "test_results.npz")) as f:
        got = {k: f[k] for k in f.files}
    if brats:
        check({k: v.shape for k, v in got.items()} == {k: (1, n_eval, 3) for k in ("dice", "sensitivity",
                                                                                   "specificity", "hd95")},
              f"{run}: brats_test_results {[(k, v.shape) for k, v in got.items()]}")
    else:
        check({k: v.shape for k, v in got.items()} == {"ged": (1, n_eval), "ncc": (1, n_eval),
                                                       "dice": (1, n_eval, cfg.n_classes)},
              f"{run}: test_results {[(k, v.shape) for k, v in got.items()]}")
        check(np.isfinite(got["ged"]).all(), f"{run}: GED {got['ged']}")
    check(np.isfinite(got["dice"]).all() and ((got["dice"] >= 0) & (got["dice"] <= 1)).all(),
          f"{run}: Dice {got['dice']}")
    pngs = sorted(os.listdir(os.path.join(log_dir, "samples")))
    n_img = min(n_eval, GENERATED[0])
    want = {f"{k}_{i}.png" for i in range(n_img) for k in ("img", "gt")}
    want |= {f"sample_{i}_{s}.png" for i in range(n_img) for s in range(GENERATED[1])}
    check(set(pngs) == want and len(pngs) == n_img * (2 + GENERATED[1]), f"{run}: {len(pngs)} PNGs {pngs[:6]}")
    shapes = {read_png(os.path.join(log_dir, "samples", p)).shape for p in pngs}
    check(shapes == {tuple(cfg.image_size[-3:-1] if brats else cfg.image_size)}, f"{run}: PNG shapes {shapes}")
    return {"pngs": len(pngs), "results": {k: float(np.nanmean(v)) for k, v in got.items()}}


def cli_runs(conv_chain, dev, card: str, workdir: str, sys_json: str, log_root: str) -> dict:
    """(a): ``train`` then ``eval --checkpoint last --num-repeats 1
    --num-samples 4 --generate-images`` of each CLI_RUNS experiment in this
    process (the launch counter read around each call), and one ``python -m
    unet_zoo_tpu_torch.train`` in a subprocess."""
    import logging

    import torch.distributed as dist

    from unet_zoo_tpu_torch.data import data_switch, lidc
    from unet_zoo_tpu_torch.experiments import SystemConfig, load_experiment
    from unet_zoo_tpu_torch.training.cli import eval_main, train_main

    root = logging.getLogger().handlers[:]
    prepare, cache_s = lidc.prepare_data, []

    def timed_prepare(*a, **kw):
        t0 = time.perf_counter()
        out = prepare(*a, **kw)
        cache_s.append(time.perf_counter() - t0)
        return out

    with open(sys_json) as f:
        sys_cfg = SystemConfig(**json.load(f))
    common = ["--sys-config", sys_json, "--log-root", log_root]
    result = {}
    for run, name, changes, iterations, per_step, per_image, per_generated in CLI_RUNS:
        path = cli_file(workdir, run, name, changes, iterations)
        cfg = load_experiment(path)
        torch.cuda.synchronize()
        conv_chain.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(lidc, "prepare_data", timed_prepare):
            check(train_main([path, *common, "--iterations", str(iterations)]) == 0, f"{run}: train exit")
        torch.cuda.synchronize()
        train_s, train_launches = time.perf_counter() - t0, conv_chain.launches
        built = cache_s.pop() if cache_s else 0.0
        conv_chain.launches = 0
        t0 = time.perf_counter()
        check(eval_main([path, *common, "--checkpoint", "last", "--num-repeats", "1", "--num-samples",
                         str(CLI_TEST_SAMPLES), "--generate-images"]) == 0, f"{run}: eval exit")
        torch.cuda.synchronize()
        eval_s, eval_launches = time.perf_counter() - t0, conv_chain.launches
        check(logging.getLogger().handlers == root and not dist.is_initialized(),
              f"{run}: the CLI left log handlers or a process group behind")
        data = data_switch(cfg.data_loader).from_config(sys_cfg, cfg)  # the split sizes the CLI saw
        if cfg.is_3d:
            n_val = data.num_examples("validation")
            n_eval = data.num_examples("test") or n_val  # the evaluation takes validation where test is empty
        else:
            n_val, n_eval = data.validation.images.shape[0], data.test.images.shape[0]
        del data
        want_train = iterations * per_step + min(CLI_VALIDATION_IMAGES, n_val) * per_image
        want_eval = n_eval * per_image + min(n_eval, GENERATED[0]) * per_generated
        check((train_launches, eval_launches) == (want_train, want_eval),
              f"{run}: conv-chain launches train {train_launches} eval {eval_launches}, expected {want_train} "
              f"{want_eval}")
        log_dir = os.path.join(log_root, cfg.log_dir_name, cfg.experiment_name)
        files = check_run_files(run, cfg, log_dir, n_eval)
        with open(os.path.join(log_dir, "metrics_train.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        check(len(losses) == iterations and all(math.isfinite(v) for v in losses), f"{run}: losses {losses}")
        route = {"float32": "conv3x3_f32_3xtf32_wgmma", "bfloat16": "conv3x3_bf16_wgmma"}[cfg.dtype] \
            if per_step else "none (BatchNorm or reversible sequences)"
        log(f"[cli] {run} ({name}, {cfg.dtype}, {cfg.effective_reversible_mode}, bs{cfg.batch_size}, "
            f"{'x'.join(map(str, cfg.image_size))}): train {iterations} steps + 1 validation {train_s:.2f} s "
            f"(of it the cache build {built:.2f} s), eval (test 1 repeat x {n_eval} x {CLI_TEST_SAMPLES} "
            f"samples + {files['pngs']} PNGs) {eval_s:.2f} s; conv-chain launches of {route}: train "
            f"{train_launches}, eval {eval_launches} (expected {want_train}, {want_eval}); losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; test means {json.dumps(files['results'])} | card: {card}")
        result[run] = {"train_s": train_s - built, "cache_s": built, "eval_s": eval_s, "train_launches": train_launches,
                       "eval_launches": eval_launches, "route": route, "pngs": files["pngs"]}
        torch.cuda.empty_cache()

    # the module entry point a user runs, in its own process
    path = os.path.join(workdir, "unet.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "unet_zoo_tpu_torch.train", path, *common[:2], "--log-root",
                           os.path.join(workdir, "subprocess"), "--iterations", "2", "--no-validate"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m unet_zoo_tpu_torch.train exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    check(os.path.exists(os.path.join(workdir, "subprocess", "lidc", "Unet", "last")), "the subprocess wrote no 'last'")
    log(f"[cli] python -m unet_zoo_tpu_torch.train unet --iterations 2 --no-validate in a subprocess: exit 0, "
        f"{sub_s:.2f} s with the interpreter's start | card: {card}")
    result["subprocess_s"] = sub_s
    return result


def native_loader(conv_chain, dev, card: str, workdir: str, sys_json: str, log_root: str) -> dict:
    """(b): the g++ build, ``next_batch(12)`` on the native and the
    h5py-loader providers (bit-identical), and NATIVE_STEPS steps of a
    native-loader ``unet`` run against the h5py-loader run, losses bit for
    bit (cuDNN deterministic, resize as matrix products)."""
    from unet_zoo_tpu_torch.data import data_switch
    from unet_zoo_tpu_torch.experiments import SystemConfig, load_experiment
    from unet_zoo_tpu_torch.native import NativeBatchProvider, store
    from unet_zoo_tpu_torch.training.cli import train_main

    existed = store.library_path().exists()
    t0 = time.perf_counter()
    check(store.native_available(), "the native batch store did not build")
    build_s = time.perf_counter() - t0
    log(f"[native] g++ build and load of {os.path.relpath(store.library_path(), REPO)}: {build_s:.2f} s "
        f"({'already built' if existed else 'built now'})")
    with open(sys_json) as f:
        sys_cfg = SystemConfig(**json.load(f))
    paths = {kind: cli_file(workdir, f"unet_{kind}", "unet", {"experiment_name": f"Unet_{kind}", "loader": kind},
                            NATIVE_STEPS) for kind in ("native", "h5py")}
    cfgs = {kind: load_experiment(p) for kind, p in paths.items()}
    providers = {kind: data_switch("lidc").from_config(sys_cfg, cfg).train for kind, cfg in cfgs.items()}
    check(isinstance(providers["native"], NativeBatchProvider), "loader='native' gave no native provider")
    batch = cfgs["native"].batch_size
    for i in range(NATIVE_STEPS):
        a, b = providers["native"].next_batch(batch), providers["h5py"].next_batch(batch)
        check(all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b)), f"batch {i} differs")
    batch_ms = {}
    for kind, p in providers.items():
        t0 = time.perf_counter()
        for _ in range(NATIVE_TIMED_BATCHES):
            p.next_batch(batch)
        batch_ms[kind] = (time.perf_counter() - t0) / NATIVE_TIMED_BATCHES * 1e3
    providers["native"].close()
    log(f"[native] next_batch({batch}) at {cfgs['native'].image_size[0]}x{cfgs['native'].image_size[1]}, 4 "
        f"graders: {NATIVE_STEPS} batches bit-identical between the native and the h5py-loader providers at one seed; "
        f"host ms a batch, mean of {NATIVE_TIMED_BATCHES}: native {batch_ms['native']:.3f}, h5py loader "
        f"{batch_ms['h5py']:.3f}")
    losses, launches = {}, {}
    with dp_deterministic():
        for kind, path in paths.items():
            conv_chain.launches = 0
            check(train_main([path, "--sys-config", sys_json, "--log-root", log_root, "--iterations",
                              str(NATIVE_STEPS), "--no-validate"]) == 0, f"{kind}: train exit")
            launches[kind] = conv_chain.launches
            with open(os.path.join(log_root, "lidc", f"Unet_{kind}", "metrics_train.jsonl")) as f:
                losses[kind] = [json.loads(line)["loss"] for line in f]
    expected = NATIVE_STEPS * len(BLOCKS) * STAGES_PER_BLOCK
    check(launches == {"native": expected, "h5py": expected}, f"native loader runs: launches {launches}")
    check(len(losses["native"]) == NATIVE_STEPS and losses["native"] == losses["h5py"],
          f"native loader losses {losses['native']} != h5py loader's {losses['h5py']}")
    log(f"[native] train unet f32 bs{batch} loader='native' vs loader='h5py', {NATIVE_STEPS} steps from one seed "
        f"(cuDNN deterministic): losses bit-identical {losses['native']}; {launches['native']} conv-chain launches "
        f"(expected {expected}) | card: {card}")
    return {"build_s": build_s, "built_now": not existed, "batch_ms": batch_ms, "launches": launches["native"],
            "losses": losses["native"]}


def host_augmentation(conv_chain, dev, card: str, log_root: str) -> dict:
    """(c): ``augment_on="host"``: 3 steps where cv2 imports; where it does
    not, the Trainer's ImportError (never device augmentation)."""
    from unet_zoo_tpu_torch.data import LIDCData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment("unet"), augment_on="host")
    if importlib.util.find_spec("cv2") is None:
        try:
            Trainer(cfg, dev, seed=0, log_dir=os.path.join(log_root, "host_aug"))
        except ImportError as e:
            check("cv2" in str(e), f"host augmentation raised {e!r}")
            log(f"[host-aug] cv2 does not import on this machine: Trainer(augment_on='host') raised ImportError "
                f"({e}); host augmentation was not run on the card")
            return {"ran": False}
        raise AssertionError("Trainer(augment_on='host') built without cv2")
    trainer = Trainer(cfg, dev, seed=0, log_dir=os.path.join(log_root, "host_aug"))
    conv_chain.launches = 0
    t0 = time.perf_counter()
    aux = trainer.train(LIDCData(synthetic.lidc_splits(HARNESS_SPLITS, IMAGE, seed=0), seed=0), iterations=3,
                        validate=False)
    took = time.perf_counter() - t0
    expected = 3 * len(BLOCKS) * STAGES_PER_BLOCK
    check(math.isfinite(aux["loss"].item()) and conv_chain.launches == expected,
          f"host augmentation: loss {aux['loss'].item()}, launches {conv_chain.launches}")
    trainer.close()
    log(f"[host-aug] unet f32 bs{cfg.batch_size} with the cv2 chain on the host: 3 steps in {took:.2f} s, "
        f"{expected} conv-chain launches, loss {aux['loss'].item():.4f} | card: {card}")
    return {"ran": True, "s": took}


def chunked_sampling(dev, card: str, log_root: str) -> dict:
    """(d): ``eval_image`` of one ``phiseg_uzh_7_5_512`` image at 100 samples
    (decoded ``sample_chunk`` at a time: ms, peak), and at 16 samples the
    chunked evaluation and its logits against the whole fold's (cuDNN
    deterministic on both)."""
    from unet_zoo_tpu_torch.data import synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer
    from unet_zoo_tpu_torch.training import trainer as trainer_module

    cfg = get_experiment(UZH_EXPERIMENT)
    trainer = Trainer(cfg, dev, seed=0, log_dir=os.path.join(log_root, "chunked"))
    arrays = synthetic.uzh_arrays((1, 1, 1), cfg.image_size[0], seed=0)
    x = torch.from_numpy(arrays["images_test"][:1])[..., None].to(dev)
    labels = torch.from_numpy(np.moveaxis(arrays["masks_test"][:1], -1, 1).copy()).long().to(dev)
    y_all, y_chosen = labels[0], labels[0, :1]
    n_big, n_cmp = CHUNK_SAMPLES
    result = {"chunk": {n: trainer.sample_chunk(x, n) for n in CHUNK_SAMPLES}}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = trainer.eval_image(x, y_all, y_chosen, n_big)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    ms = cuda_ms(lambda: trainer.eval_image(x, y_all, y_chosen, n_big), 1)
    check(math.isfinite(out["ged"].item()) and -1 <= out["ncc"].item() <= 1 and
          bool(((out["dice"] >= 0) & (out["dice"] <= 1)).all()), f"100-sample evaluation {out}")
    log(f"[chunked] eval_image of one {cfg.image_size[0]}x{cfg.image_size[1]} {UZH_EXPERIMENT} image (f32) at "
        f"{n_big} samples, {result['chunk'][n_big]} decoded at a time: {ms:.1f} ms, peak {peak:.1f} MiB above "
        f"the state; GED {out['ged'].item():.4f} NCC {out['ncc'].item():.4f} | card: {card}")
    with dp_deterministic():
        chunked = trainer.eval_image(x, y_all, y_chosen, n_cmp)
        torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(trainer_module, "EVAL_SAMPLE_PIXELS", 1 << 62):
            whole = trainer.eval_image(x, y_all, y_chosen, n_cmp)
        torch.cuda.synchronize()
        whole_peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
        gen = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa: E731
        with torch.inference_mode():
            logits_chunked = trainer.state.model.sample(x, n_cmp, generator=gen(), chunk=result["chunk"][n_cmp])
            logits_whole = trainer.state.model.sample(x, n_cmp, generator=gen())
        logit_err = (logits_chunked - logits_whole).abs().max().item()
        logit_tol = F32_RTOL * logits_whole.abs().max().item()
    # cuDNN takes other float32 algorithms for a batch of 1 than of 16, so the
    # logits round apart (the CPU test holds them bit for bit): the logits
    # within F32_RTOL, NCC within NCC_ATOL, every other result equal
    ncc_err = (whole["ncc"] - chunked["ncc"]).abs().item()
    differ = [k for k in whole if k != "ncc" and not torch.equal(whole[k], chunked[k])]
    check(result["chunk"][n_cmp] is not None and not differ and ncc_err <= NCC_ATOL and logit_err <= logit_tol,
          f"chunked vs whole fold at {n_cmp} samples: {differ} differ, NCC by {ncc_err:.3e}, logits by "
          f"{logit_err:.3e} (tol {logit_tol:.3e}; chunk {result['chunk'][n_cmp]})")
    log(f"[chunked] {n_cmp} samples decoded {result['chunk'][n_cmp]} at a time against the whole fold (peak "
        f"{whole_peak:.1f} MiB): logits max|diff| {logit_err:.3e} (tol {logit_tol:.3e}, {'bit-identical' if logit_err == 0 else 'cuDNN rounds a batch of 1 otherwise than 16'}); "
        f"GED, Dice, loss terms, mean prediction and first sample equal; NCC {ncc_err:.3e} apart (tol {NCC_ATOL}) "
        f"| card: {card}")
    result.update(logits_max_abs_diff=logit_err, ncc_diff=ncc_err)
    del trainer
    torch.cuda.empty_cache()
    result.update(ms=ms, peak_mib=peak, whole_16_peak_mib=whole_peak)
    return result


def cli_phase(conv_chain, dev, card: str, log_root: str) -> dict:
    """Phase 13: the CLIs on the card, the native loader, host augmentation
    and chunked sampling."""
    from unet_zoo_tpu_torch.data import brats, synthetic, uzh
    from unet_zoo_tpu_torch.data.cache import find_cache
    from unet_zoo_tpu_torch.experiments import get_experiment

    t0 = time.perf_counter()
    present = {m: importlib.util.find_spec(m) is not None for m in CLI_MODULES}
    log(f"[cli] modules on this machine (importlib.util.find_spec): "
        f"{', '.join(f'{m} {present[m]}' for m in CLI_MODULES)}")
    workdir = os.path.join(log_root, "cli")
    os.makedirs(workdir)
    preproc, preproc_uzh = os.path.join(workdir, "preproc"), os.path.join(workdir, "preproc_uzh")
    sys_json = os.path.join(workdir, "config.json")
    with open(sys_json, "w") as f:
        json.dump({"data_root": os.path.join(workdir, "data_lidc.pickle"), "preproc_folder": preproc,
                   "uzh_preproc_folder": preproc_uzh, "brats_root": os.path.join(workdir, "brats_raw")}, f)
    synthetic.make_lidc_pickle(os.path.join(workdir, "data_lidc.pickle"), num_cases=CLI_LIDC_CASES[0],
                               num_subjects=CLI_LIDC_CASES[1], size=IMAGE, seed=0)
    caches, cache_s = {}, {}
    uzh_cfg, brats_cfg = get_experiment("phiseg_uzh_7_5_192"), get_experiment("phiseg_brats")
    for key, make, path in (
            ("uzh_prostate", lambda p: synthetic.make_uzh_cache(p, CLI_UZH_SPLITS, uzh_cfg.image_size[0], 3, seed=0),
             os.path.join(preproc_uzh, uzh.cache_name(uzh_cfg.image_size, uzh_cfg.target_resolution))),
            ("brats", lambda p: synthetic.make_brats_cache(p, CLI_BRATS_SPLITS, brats_cfg.image_size, seed=0),
             os.path.join(preproc, brats.cache_name(brats_cfg.image_size)))):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t1 = time.perf_counter()
        caches[key] = make(path)
        cache_s[key] = time.perf_counter() - t1
    runs_root = os.path.join(workdir, "logs")
    runs = cli_runs(conv_chain, dev, card, workdir, sys_json, runs_root)
    for key in ("uzh_prostate", "brats"):
        runs[{"uzh_prostate": "phiseg_uzh_7_5_192", "brats": "phiseg_brats"}[key]]["cache_s"] = cache_s[key]
    caches["lidc"] = find_cache(os.path.join(preproc, "data_lidc.hdf5"))
    if not present["h5py"]:
        check(all(os.path.isdir(c) and c.endswith("_npy") for c in caches.values()), f"caches {caches}")
    log(f"[cli] caches ({'HDF5' if present['h5py'] else 'npy directories: h5py does not import'}): "
        f"{', '.join(f'{k} {os.path.relpath(v, workdir)}' for k, v in caches.items())}; UZH and BraTS written in "
        f"{cache_s['uzh_prostate']:.2f} s and {cache_s['brats']:.2f} s")
    native = native_loader(conv_chain, dev, card, workdir, sys_json, runs_root)
    host = host_augmentation(conv_chain, dev, card, workdir)
    chunked = chunked_sampling(dev, card, workdir)
    took = time.perf_counter() - t0
    log(f"[cli] phase 13 took {took:.1f} s | card: {card}")
    return {"modules": present, "runs": runs, "native": native, "host_augmentation": host, "chunked": chunked,
            "seconds": took}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    started = time.perf_counter()
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
    ptxas = ptxas_report(build_log)
    sass = sass_check(_build.library_path(), build_log)
    check(chain_route(torch.float32, dev) == F32_ROUTE, f"f32 chains route to {chain_route(torch.float32, dev)}")

    # 2. kernel vs plain version on the card
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for shape, chans in TEST_SHAPES:
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            ks, bs = chain_weights(chans, gen, dev, scale=0.2)
            compare(conv_chain, x, ks, bs, f"{name} test {shape} {chans}")
        for shape, chans in EDGE_SHAPES + (F32_EDGE_SHAPES if dtype == torch.float32 else []):
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            ks, bs = chain_weights(chans, gen, dev)
            compare(conv_chain, x, ks, bs, f"{name} edge {shape} {chans}")
            for ci, co in chans:
                log(f"[plan]   {ci}->{co}: {plan_line(conv_chain, (*shape[:3], ci), co, dtype)}")
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
        torch.cuda.empty_cache()

        # 10. PHiSeg3D and the BraTS path
        brats_phase(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 11. the UZH prostate path
        uzh = uzh_phase(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 12. data parallelism
        dp = dp_phase(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 13. the CLIs on the card, the native loader, host augmentation, chunked sampling
        cli = cli_phase(conv_chain, dev, card, log_root)
        torch.cuda.empty_cache()

        # 14. spatial sharding
        space = space_phase(conv_chain, dev, card, log_root)

    log(f"[env] phases 1-14 took {time.perf_counter() - started:.1f} s")
    runs = cli["runs"]
    main = blocks[BATCH]
    f32_rows = prob["blocks"]["rows"]["prob_unet"]
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
        "uzh_launches": uzh["launches"],
        "uzh_512_step_ms": {k: v["ms"] for k, v in uzh["steps"].items()},
        "uzh_512_step_peak_mib": {k: v["peak_mib"] for k, v in uzh["steps"].items()},
        "uzh_512_validation": uzh["evaluation"],
        # phase 12: launches of each one-process NCCL mesh U-Net step, and of
        # each f32 U-Net step on each of the two gloo processes
        "dp_world1_step_launches": dp["world1"]["unet"]["launches"],
        "dp_world1_step_ms": {k: v["ms"] for k, v in dp["world1"].items()},
        "dp_world1_plain_step_ms": {k: v["plain_ms"] for k, v in dp["world1"].items()},
        "dp_two_process_f32_step_launches": [r["launches"] for r in dp["ranks"]["unet"]],
        "dp_two_process_step_ms": {k: [r["ms"] for r in dp["ranks"][k]] for k in ("unet", PHISEG_EXPERIMENT)},
        # phase 13: launches of the bf16 unet file's train and eval --generate-images CLI calls
        "cli_launches": {k: {"train": runs[k]["train_launches"], "eval": runs[k]["eval_launches"]}
                         for k in ("unet_bf16",)},
        "cli_phase_s": cli["seconds"],
        # phase 14: launches of each space-2 U-Net step on each of the two
        # processes (on h + 2-row halo tiles), the halo tiles against the
        # unsplit kernel, ms a step and the UZH peaks a process
        "space_step_launches": space["unet"]["launches"],
        "space_halo_tiles_bit_identical": space["tiles"]["bit_identical"],
        "space_halo_tiles_max_abs_err": space["tiles"]["max_abs_err"],
        "space_unet_step_ms": space["unet"]["ms"],
        "space_uzh_step_ms": space["uzh"]["ms"],
        "space_uzh_one_process_ms": space["uzh"]["one_ms"],
        "space_uzh_peak_mib": space["uzh"]["peak_mib"],
        "space_uzh_one_process_peak_mib": space["uzh"]["one_peak_mib"],
        "space_uzh_one_process_shared_peak_mib": space["uzh"]["one_shared_peak_mib"],
        "space_uzh_graph_mib": space["uzh"]["graph_mib"],
        "space_uzh_one_process_graph_mib": space["uzh"]["one_graph_mib"],
        "space_phase_s": space["seconds"],
    }, {
        "name": "fused_conv_chain_f32",
        "kernel": F32_ROUTE,
        "route": "cuda",
        "source": "unet_zoo_tpu_torch/csrc/conv_chain.cu",
        "replaces": "unet_zoo_tpu/ops/pallas/conv_chain.py:132",
        # the f32 main path: one registered prob_unet step, the count set to 0 just before it
        "launches": prob["f32"]["launches"],
        "max_abs_err": prob["blocks"]["f32_max_abs_err"],
        # the 13 ProbUNet trunk blocks at bs12 (phase 9 (b)), device ms; bound at 3xTF32
        "ms": sum(r["ms"] for r in f32_rows),
        "plain_ms": sum(r["plain_ms"] for r in f32_rows),
        "bound_ms": sum(r["bound_ms"] for r in f32_rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in f32_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in f32_rows),
        "fma_bound_ms": sum(r["fma_bound_ms"] for r in f32_rows),
        "event_ms": sum(r["event_ms"] for r in f32_rows),
        "library_event_ms": sum(r["library_event_ms"] for r in f32_rows),
        "unet_blocks_ms": sum(r["ms"] for r in prob["blocks"]["rows"]["unet"]),
        "unet_blocks_library_ms": sum(r["library_ms"] for r in prob["blocks"]["rows"]["unet"]),
        "prob_unet_step": prob["f32"],
        "unet_step_bs12": prob["f32_unet"],
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith(F32_ROUTE)},
        # phase 13: launches of the registered (f32) unet and prob_unet train and eval --generate-images CLI
        # calls, and of the native-loader unet run's 3 steps
        "cli_launches": {k: {"train": runs[k]["train_launches"], "eval": runs[k]["eval_launches"]}
                         for k in ("unet", "prob_unet")},
        "native_loader_launches": cli["native"]["launches"],
        "cli_runs_s": {k: {f: v[f] for f in ("cache_s", "train_s", "eval_s")} for k, v in runs.items()
                       if isinstance(v, dict)},
        "native_batch_ms": cli["native"]["batch_ms"],
        "native_build_s": cli["native"]["build_s"],
        "chunked_eval100_ms": cli["chunked"]["ms"],
        "chunked_eval100_peak_mib": cli["chunked"]["peak_mib"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--space-worker"]:
        space_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *([int(sys.argv[5]), sys.argv[6]]
                                                                         if len(sys.argv) > 5 else []))
        sys.exit(0)
    sys.exit(main())
