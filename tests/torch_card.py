"""Shapes, gates and helpers shared by the port's card tests
(``tests/test_torch_*_card.py``), their multi-process workers
(``tests/torch_*_card_worker.py``) and the ``tools/torch_*.py`` scripts.

Imports torch, numpy and the port only: no JAX, since the card's machine
has none, and no pytest, since the tools import it too. The card tests'
fixture and the checks that several card modules share are in
``tests/torch_card_checks.py``. The card tests run without the suite's
``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_*_card.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from unet_zoo_tpu_torch.ops.pallas import conv_chain

BATCH = 512  # the bf16 U-Net forward's batch
IMAGE = 128
FILTERS = (32, 64, 128, 192)
STAGES_PER_BLOCK = 3
# the 7 U-Net blocks at full width: (name, spatial size, C_in after the concat, C_out)
BLOCKS = [
    ("down0", 128, 1, 32), ("down1", 64, 32, 64), ("down2", 32, 64, 128),
    ("down3", 16, 128, 192), ("up2", 32, 320, 128), ("up1", 64, 192, 64),
    ("up0", 128, 96, 32),
]
UNET_LAUNCHES = len(BLOCKS) * STAGES_PER_BLOCK
# the 13 trunk blocks of the 7-level prob_unet experiment at full width; 39 launches a forward
PROB_BLOCKS = [
    ("down0", 128, 1, 32), ("down1", 64, 32, 64), ("down2", 32, 64, 128), ("down3", 16, 128, 192),
    ("down4", 8, 192, 192), ("down5", 4, 192, 192), ("down6", 2, 192, 192), ("up5", 4, 384, 192),
    ("up4", 8, 384, 192), ("up3", 16, 384, 192), ("up2", 32, 320, 128), ("up1", 64, 192, 64),
    ("up0", 128, 96, 32),
]
PROB_LAUNCHES = len(PROB_BLOCKS) * STAGES_PER_BLOCK
PROB_BATCH = 12
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
TRAIN_BATCH = 64
PHISEG_EXPERIMENT = "phiseg_7_5_12"
PARITY_BATCH = 2  # card against CPU, full width
EVAL_SAMPLES = 100  # the reference's quantitative protocol
EVAL_ANNOTATORS = 4
# the harness on synthetic LIDC: (train, val, test) images, iterations,
# validation cadence and samples, and the test sweep's repeats and samples
HARNESS_SPLITS = (64, 8, 8)
HARNESS_ITERATIONS = 20
HARNESS_VALIDATION_FREQUENCY = 10
HARNESS_VALIDATION_SAMPLES = 16
HARNESS_TEST_REPEATS, HARNESS_TEST_SAMPLES = 2, 10
# the batches at which the ProbUNet path runs its trunk: a sample's and a
# test image's loss forward (1), the train step (12), a validation image's
# loss repeats (validation_samples, 16)
PROB_CHECK_BATCHES = (1, PROB_BATCH, HARNESS_VALIDATION_SAMPLES)
# conv-chain launches of each family: (a train step, an image validated:
# the U-Net's one forward; ProbUNet's sample, then its loss forward)
HARNESS_LAUNCHES = {"unet": (UNET_LAUNCHES,) * 2, "phiseg": (0, 0), "prob_unet": (PROB_LAUNCHES, 2 * PROB_LAUNCHES)}
MODE_STEPS = 12  # bf16 steps of a memory-mode or ProbUNet path from a fixed seed
MIB = 2 ** 20
MEMORY_MODES = ("plain", "remat", "reversible")

# --- the gates -------------------------------------------------------------
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
# launches of each block, at each batch, that must repeat the first bit for
# bit: the kernel's sums run in a fixed order, so any difference is a race
REPEATS = 100
# bf16 train step, each kernel-path step against the same step on a plain
# path from the same state and draws (``plain_chain``): step 1 on the plain
# version (on an NVIDIA H100 80GB HBM3 at 700 W: loss 2.1e-5, gradients
# 2.1e-2 of max|grad|), later steps on the kernel's own rounding
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL_OF_MAX = 0.06
# f32 card vs CPU, the same weights and eps. Eval mode (BatchNorm an affine
# map of the running statistics): every output and gradient within
# PHISEG_EVAL_OF_MAX of its max|ref|. Train mode: batch statistics over 8
# values a channel at the coarsest level amplify rounding with depth (at
# the published structure on the CPU, JAX against the port: outputs 5e-5 to
# 1.7e-4 of max, the whole gradient 5e-4 to 3.9e-3 relative L2,
# tests/test_torch_phiseg.py), so outputs within PHISEG_TRAIN_OF_MAX of
# max|ref|, the gradient as one vector within PHISEG_TRAIN_GRAD_L2, the
# running statistics within PHISEG_STATS_RTOL of each buffer's max; the loss
# terms within PHISEG_LOSS_RTOL in both modes
PHISEG_EVAL_OF_MAX = 1e-4
PHISEG_EVAL_GRAD_OF_MAX = 5e-3
PHISEG_TRAIN_OF_MAX = 1e-3
PHISEG_TRAIN_GRAD_L2 = 2e-2
PHISEG_STATS_RTOL = 1e-3
PHISEG_LOSS_RTOL = 1e-5
# f32 card vs CPU in eval mode, each gradient tensor's relative L2 distance:
# single entries of ProbUNet's trunk gradients move further than PHiSeg's
# (7.5e-3 of the tensor's max|g| in up2's first conv, over PHiSeg's per-entry
# 5e-3; by relative L2 2.4e-3 at worst; an NVIDIA H100 80GB HBM3 at 700 W),
# where an entry is a sum that cancels or a pre-activation sits at ReLU's zero
PROB_EVAL_TENSOR_L2 = 1e-2
# the metrics on the card against the CPU on the same inputs: intersections
# are exact counts in float32 and Dice a ratio of them (equal); GED sums
# the same distances in another order (GED_RTOL of max(1, |ref|)); NCC's
# means and standard deviations round differently (NCC_ATOL)
GED_RTOL = 1e-5
NCC_ATOL = 1e-4
# f32, TF32 off: at 64 channels x 128x128 x batch 12 (196608 values a
# channel) float32 itself is far from exact: autograd's f32 input gradient
# lies 1.1e-2 of its max from a float64 run of the same chain (an NVIDIA
# H100 80GB HBM3 at 700 W; 1.8e-2 on a CPU), so no 1e-3-of-max gate holds
# against autograd there. Each of the reversible Function's f32 gradients is
# held by its relative L2 distance from the float64 gradient: at most
# REV_F32_VS_AUTOGRAD times autograd's f32 distance plus 1e-5 (the
# reconstruction adds its own rounding to the earlier blocks: 1.81 times
# autograd's distance at worst, in the first block's f kernel, on that card;
# within 11% for every tensor on a CPU)
REV_F32_VS_AUTOGRAD = 3.0
# bf16: each reconstruction starts from outputs rounded to bf16, so the
# Function's gradient is held by its distance from the f32 gradient, at most
# REV_BF16_VS_AUTOGRAD times autograd's bf16 distance plus 0.01 (relative L2)
REV_BF16_VS_AUTOGRAD = 2.0
# the first bf16 RevPHiSeg step against its f32 twin from the same weights
# and draws: the whole gradient within REV_STEP_GRAD_L2 (relative L2) of the
# f32 one, and each step's parameter change within ADAM_OF_LR * lr of
# coupled-L2 Adam's first update written out from that step's own gradient
REV_STEP_GRAD_L2 = 0.3
ADAM_OF_LR = 1e-3
# the gradient of a bias that BatchNorm follows is the regularizer's term
# alone, REG_WEIGHT * b / sqrt(sum(b^2) + 1e-12), written out here from b:
# within REG_GRAD_RTOL of the term's max|value| (the model sums the norms
# with multi-tensor kernels, in another order)
REG_GRAD_RTOL = 1e-5
# data parallelism, two processes sharing the card over gloo against one.
# PHiSeg is held at the train-mode gates above: its two processes take
# BatchNorm's statistics by the group's formula, max(E[x^2] - E[x]^2, 0) as
# the JAX package, where one process takes the library's Welford pass, and
# train-mode BatchNorm at the published depth amplifies that rounding (the
# gradient 3.0e-3 relative L2 at step 1). ``tools/torch_dp_faults.py`` read
# the first step with a fault planted on an NVIDIA H100 80GB HBM3 at 700 W:
# BatchNorm unsynced 1.29, gradients unreduced 1.54 (statistics 0.31 of
# their max unsynced), the f32 U-Net's gradients unreduced 0.165 against
# 1.2e-6 without a fault; every gate below lies between the two readings.
# The float32 U-Net step at global bs64 on two processes against one, each
# step from the same state: the gradient (relative L2) within DP_F32_GRAD_L2
# (the same per-image terms, cuDNN's weight gradients summed over 32 images a
# process, then over the two), every parameter within DP_PARAM_ATOL_LR lr
# but an entry whose gradient is within ROUNDING_OF_MAX of its tensor's
# max|g|, whose first Adam update lr * sign(g) may take the other sign,
# ROUNDING_FLIP_LR lr away, in at most FLIP_SHARE of all entries
DP_F32_GRAD_L2 = 1e-4
DP_PARAM_ATOL_LR, ROUNDING_OF_MAX, ROUNDING_FLIP_LR, FLIP_SHARE = 2e-2, 1e-3, 2.01, 1e-3
# Trainer.train on two processes against one, bf16, free trajectories from
# one seed: the final parameters' distance from the one-process run's,
# relative to how far that run moved them (||p2 - p1|| / ||p1 - p0||). The
# bf16 weight gradients of 32 images a process round otherwise than those of
# 64, Adam's first update turns the entries near 0 into +-lr, and 20 steps
# carry that on (0.048-0.084 measured, the worst entry 20.4 lr, on an NVIDIA
# H100 80GB HBM3 at 700 W); with a fault planted (``tools/torch_dp_faults.py``,
# same card) the processes end 0.53 of it away where both trained on the
# first half of every batch, 0.52 where each stepped on its own gradient
DP_TRAIN_REL_MOVE = 0.25
DP_RANKS = 2  # processes sharing the one card over gloo
DP_PHISEG_BATCH = 12  # the registered global batch, 6 a process
# each spatially sharded process may take this share of the card's memory:
# two share it, and a strict-f32 cuDNN convolution takes the largest
# workspace that the allocator grants (an FFT forward of tens of GiB at
# 512x512), so without a share the first process to ask starves the other
# (out of memory at 78.5 GiB on an NVIDIA H100 80GB HBM3, PERF.md); within
# its share cuDNN takes the plans whose workspace fits
SPACE_MEMORY_FRACTION = 0.47
# the most of one process's forward graph (the autograd graph's saved
# tensors) that a space-2 process may hold: half the rows plus the halo
# tiles' copies read 60.8% on an NVIDIA H100 80GB HBM3 (PERF.md), a layout
# that kept most levels replicated would read near 100%
SPACE_GRAPH_SHARE = 0.75


def card_line() -> str:
    """The card's name and power limit, to print beside a reading."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` by CUDA events around ``iters`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_workers(script, workdir, world: int, args=(), timeout: float = 600) -> None:
    """Starts ``world`` processes of ``script`` (``RANK PORT WORKDIR *args``)
    together, each writing its output to ``WORKDIR/worker_<rank>.log`` (a
    pipe read after another's could fill and deadlock the collectives), and
    waits for them within ``timeout`` seconds in all, then kills them; each
    must exit 0 having printed ``DONE <rank>``."""
    port = free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"worker_{r}.log"), "w") for r in range(world)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(workdir), *map(str, args)],
                              cwd=root, stdout=f, stderr=subprocess.STDOUT) for r, f in enumerate(logs)]
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
    outs = [open(os.path.join(workdir, f"worker_{r}.log")).read() for r in range(world)]
    failed = [(r, p.returncode, "\n".join(out.splitlines()[-40:])) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0 or f"DONE {r}" not in out]
    assert not failed, "".join(f"process {r} of {script} exited {rc}:\n{tail}\n" for r, rc, tail in failed)


def bf16_ulp(value: float) -> float:
    return 2.0 ** (math.floor(math.log2(value)) - 7)


def chain_weights(chans, gen, device, scale=None):
    """Kernels and biases of a chain, He-scaled unless ``scale`` is given."""
    ks, bs = [], []
    for ci, co in chans:
        std = scale if scale is not None else (2.0 / (9 * ci)) ** 0.5
        ks.append((torch.randn((co, ci, 3, 3), generator=gen) * std).to(device))
        bs.append((torch.randn((co,), generator=gen) * (1.0 if scale is not None else 0.1)).to(device))
    return ks, bs


def block_chans(ci: int, co: int) -> list:
    return [(ci, co)] + [(co, co)] * (STAGES_PER_BLOCK - 1)


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


@contextlib.contextmanager
def no_host_sync():
    """A host sync inside the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


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


def deterministic():
    """cuDNN deterministic and ``deterministic_resize`` (whose backward has no
    atomics): two runs of a step then agree bit for bit."""
    stack = contextlib.ExitStack()
    stack.callback(setattr, torch.backends.cudnn, "deterministic", torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    stack.enter_context(deterministic_resize())
    return stack


def train_batches(n: int, dev, batch: int = TRAIN_BATCH, size: int = IMAGE):
    """n batches of (batch, size, size, 1) noise from a fixed seed, labelled
    where a 9x9 box blur of the image is positive: a map a U-Net can learn,
    so the loss can fall."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n * batch, 1, size, size), generator=gen, device=dev)
    y = torch.nn.functional.avg_pool2d(x, 9, 1, 4) > 0
    return x.view(n, batch, size, size, 1), y.view(n, batch, size, size).long()


def z_eps(cfg, batch: int, gen, dev):
    """The train step's z noise: ProbUNet's posterior (B, latent_dim), or
    PHiSeg's one N(0, 1) tensor a latent level."""
    if cfg.model == "prob_unet":
        return torch.randn((batch, cfg.latent_dim), generator=gen, device=dev)
    return [torch.randn((batch, IMAGE >> (lvl + 2), IMAGE >> (lvl + 2), cfg.zdim), generator=gen, device=dev)
            for lvl in range(cfg.latent_levels)]


def same_state(a, b, path: str = "state") -> None:
    """Two train states (``state_dict``s) are equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{path} changed"
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), f"{path}: keys changed"
        for k in a:
            same_state(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            same_state(u, v, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a} -> {b}"


def rel_err(a, b) -> float:
    """max|a - b| over max|b|, on the CPU."""
    b = b.detach().cpu()
    return ((a.detach().cpu() - b).abs().max() / b.abs().max()).item()


def flat_rel_l2(got: dict, want: dict) -> float:
    """The relative L2 distance of two gradients, each taken as one vector."""
    g = torch.cat([got[n].detach().cpu().flatten().double() for n in want])
    w = torch.cat([want[n].detach().cpu().flatten().double() for n in want])
    return ((g - w).norm() / w.norm()).item()


def stats_err(got_model, want_model) -> float:
    """The running statistics' worst max|diff| over their buffer's max."""
    got = dict(got_model.named_buffers())
    return max(rel_err(got[n], b) for n, b in want_model.named_buffers())


def metric_inputs(n_classes: int, n: int, seed: int):
    """Fixed inputs at the evaluation's shape: logits (n, IMAGE, IMAGE, C)
    whose argmax is each sample's labels, with two samples all background,
    and EVAL_ANNOTATORS annotators' blobs, the last one empty."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMAGE, 0:IMAGE]
    logits = rng.standard_normal((n, IMAGE, IMAGE, n_classes)).astype(np.float32)
    for c in range(1, n_classes):
        cy, cx = rng.uniform(0.3, 0.7, 2) * IMAGE
        logits[..., c] += 3.0 * ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.15 * IMAGE) ** 2).astype(np.float32)
    logits[:2, ..., 0] += 10.0
    y_all = np.zeros((EVAL_ANNOTATORS, IMAGE, IMAGE), np.int64)
    for a in range(EVAL_ANNOTATORS - 1):
        for c in range(1, n_classes):
            cy, cx = rng.uniform(0.3, 0.7, 2) * IMAGE
            y_all[a][(yy - cy) ** 2 + (xx - cx) ** 2 < (rng.uniform(0.08, 0.2) * IMAGE) ** 2] = c
    return torch.from_numpy(logits), torch.from_numpy(y_all)


def lidc_data():
    """In-memory synthetic LIDC of HARNESS_SPLITS at 128x128, 4 graders."""
    from unet_zoo_tpu_torch.data import LIDCData, synthetic

    return LIDCData(synthetic.lidc_splits(HARNESS_SPLITS, IMAGE, seed=0), seed=0)



def dp_train_config():
    """``Trainer.train`` of the data-parallel checks: 20 bf16 ``unet`` steps
    at bs64 with a validation every 10."""
    from unet_zoo_tpu_torch.experiments import get_experiment

    return dataclasses.replace(get_experiment("unet"), dtype="bfloat16", iterations=HARNESS_ITERATIONS,
                               validation_frequency=HARNESS_VALIDATION_FREQUENCY,
                               logging_frequency=HARNESS_VALIDATION_FREQUENCY,
                               num_validation_images=HARNESS_SPLITS[1], validation_samples=HARNESS_VALIDATION_SAMPLES)


def state_bytes(trainer) -> int:
    """Parameters, buffers and the optimizer's state tensors."""
    state = trainer.state
    tensors = [*state.model.parameters(), *state.model.buffers()]
    tensors += [t for s in state.optimizer.state.values() for t in s.values() if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in tensors)


def step_peak(experiment: str, mode: str, batch: int, dev, log_dir: str, tf32: bool = False) -> dict:
    """The peak allocated bytes of one steady float32 train step of
    ``experiment`` in memory mode ``mode`` at ``batch``, with cuDNN's TF32
    as ``tf32`` says (``Trainer`` sets it), and the state's own bytes."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(experiment), batch_size=batch, reversible_mode=mode, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((batch, *cfg.image_size, cfg.input_channels), generator=gen, device=dev)
    y = (x[..., 0] > 0).long()
    if cfg.is_3d:  # BraTS: one-hot WT/TC/ET, nested regions
        y = torch.stack([x[..., 0] > t for t in (0.0, 0.5, 1.0)], -1).float()
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir, tensorboard=False, tf32=tf32)
    trainer.train_step(x, y)  # warm-up: Adam's moments, the library's workspaces
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    trainer.train_step(x, y)
    torch.cuda.synchronize(dev)
    result = {"experiment": experiment, "mode": mode, "batch": batch,
              "peak_bytes": torch.cuda.max_memory_allocated(dev), "base_bytes": base,
              "state_bytes": state_bytes(trainer)}
    trainer.close()
    del trainer, x, y
    torch.cuda.empty_cache()
    return result
