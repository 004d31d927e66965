#!/usr/bin/env python3
"""Per-stage and per-block times of the port's conv-chain kernel on one CUDA card.

    python3 tools/torch_conv_chain_stages.py                    # from the repository root
    python3 tools/torch_conv_chain_stages.py --plans            # also time other launch plans
    python3 tools/torch_conv_chain_stages.py --dtype float32    # the f32 kernel at ProbUNet's stages
    python3 tools/torch_conv_chain_stages.py --blocks           # whole blocks against plain and cuDNN

bfloat16 (the default): each of the 21 stages of the U-Net's main path (7
blocks x 3 stages, full width, batch 512). float32: each of the 39 stages of
ProbUNet's 13 trunk blocks (the U-Net's 21 among them) at batch 12, the
registered f32 step's. Random weights from a seed. For each stage it prints
the launch plan, the kernel's time (CUDA events, min of 2 rounds of 10
launches), its TFLOP/s, the bytes/s of the stage's own input and output,
and the share of the stage's bound (the larger of its FLOPs at the peak,
bf16 or 3xTF32, and those bytes at the memory rate), beside the card's name
and power limit. ``--plans`` times each stage again under a few other plans
(bf16: 4-row tiles, two halo stages, weights in a ring rather than
resident; f32: one warpgroup a tile, 32 channels a block, weights in a
ring), after checking each against the plain version.

``--blocks`` times whole 3-stage blocks instead, each checked against its
plain version first: the U-Net's 7 in bf16 at batch 512 and 64, and in
float32 (TF32 off) at batch 12 with ProbUNet's 13. For each block, the
device ms of the kernel, of its plain version
(``fused_conv_chain_reference``) and of cuDNN conv+bias+ReLU in the
block's dtype, beside its bound and TFLOP/s. Device ms: a sleep kernel
holds the stream while the host queues every timed call, and CUDA events
around them read the device alone; a round whose first event the device
reached before the last call was queued (the launch queue holds ~1024
launches) raises rather than read the host's pace. Then the bf16 U-Net's
forward at batch 512: its kernel launches (21) and device ms. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from benchmark.harness.timing import PEAK_3XTF32_FLOPS, PEAK_BF16_FLOPS, bound, chain_cost  # noqa: E402
from torch_card import (BATCH, BF16_ULPS, BLOCKS, F32_RTOL, FILTERS, IMAGE, PROB_BATCH, PROB_BLOCKS,  # noqa: E402
                        TRAIN_BATCH, UNET_LAUNCHES, bf16_ulp, block_chans, card_line, chain_weights, cuda_ms)
from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain  # noqa: E402


# the other plans of --plans: launch_plan's (bf16) or f32_launch_plan's own
# choice replaced by these
PLANS = {"4-row tiles": dict(tile_h=4), "2 halo stages": dict(halo_stages=2),
         "weights in a ring": dict(resident=False)}
F32_PLANS = {"one warpgroup": dict(warpgroups=1), "32 channels a block": dict(block_n=32),
             "weights in a ring": dict(resident=False)}
# the tables of --blocks: (dtype, batch, the blocks' name, the blocks)
BLOCK_TABLES = ((torch.bfloat16, BATCH, "unet", BLOCKS), (torch.bfloat16, TRAIN_BATCH, "unet", BLOCKS),
                (torch.float32, PROB_BATCH, "unet", BLOCKS), (torch.float32, PROB_BATCH, "prob_unet", PROB_BLOCKS))
ROUNDS = 3  # timed rounds of each call; the least is kept
BLOCK_CALLS = 10  # calls a round of one block: 30 kernel launches, far inside the launch queue
FORWARD_CALLS = 3  # calls a round of the bs512 forward
SLEEP_CYCLES = 40_000_000  # the stream's hold, ~20 ms at the H100's clock


def plans_of(dtype: torch.dtype) -> tuple:
    """(the plan function, the other plans of --plans) of a dtype's kernel."""
    if dtype == torch.float32:
        return conv_chain.f32_launch_plan, F32_PLANS
    return conv_chain.launch_plan, PLANS


def check_chain(x, ks, bs, label: str) -> None:
    """The kernel against its plain version: f32 within F32_RTOL of
    max|plain|, bf16 within BF16_ULPS ulps of it."""
    out = conv_chain.fused_conv_chain(x, ks, bs)
    ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = F32_RTOL * scale if x.dtype == torch.float32 else BF16_ULPS * bf16_ulp(scale)
    assert err <= tol, f"{label}: max|diff| {err} > {tol}"


def library_chain(x, ks, bs):
    """The chain as a PyTorch user would write it: per stage a cuDNN conv
    with the bias in x.dtype, then ReLU (an NCHW view of the NHWC input)."""
    y = x.permute(0, 3, 1, 2)
    for k, b in zip(ks, bs):
        y = torch.relu(torch.nn.functional.conv2d(y, k.to(x.dtype), b.to(x.dtype), padding=1))
    return y


def device_ms(fn, calls: int) -> float:
    """The device's ms a call of ``fn``, the least of ROUNDS rounds: in
    each, after one untimed call, a sleep kernel holds the stream while the
    host queues ``calls`` calls between two CUDA events."""
    fn()
    best = float("inf")
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        queued_ahead = not start.query()
        end.record()
        end.synchronize()
        if not queued_ahead:
            raise RuntimeError(f"the device ran out of queued work after {calls} calls; time fewer")
        best = min(best, start.elapsed_time(end) / calls)
    return best


def block_tables(dev, card: str) -> None:
    """--blocks: every table of BLOCK_TABLES, then the bf16 forward."""
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        for dtype, batch, net, blocks in BLOCK_TABLES:
            f32 = dtype == torch.float32
            name = "f32" if f32 else "bf16"
            peak, itemsize = (PEAK_3XTF32_FLOPS, 4) if f32 else (PEAK_BF16_FLOPS, 2)
            sums = [0.0] * 4
            for block, size, ci, co in blocks:
                chans = block_chans(ci, co)
                ks, bs = chain_weights(chans, gen, dev)
                x = torch.randn((batch, size, size, ci), generator=gen).to(dev, dtype)
                label = f"{name} {net} {block} ({batch}, {size}, {size}, {ci})->{co}"
                check_chain(x, ks, bs, label)
                packed = [conv_chain.pack_kernel(k, dtype) for k in ks]
                k_ms = device_ms(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), BLOCK_CALLS)
                p_ms = device_ms(lambda: conv_chain.fused_conv_chain_reference(x, ks, bs), BLOCK_CALLS)
                c_ms = device_ms(lambda: library_chain(x, ks, bs), BLOCK_CALLS)
                flops, nbytes = chain_cost(batch, size, chans, itemsize)
                b_ms, by = bound(flops, nbytes, peak)
                sums = [a + b for a, b in zip(sums, (k_ms, b_ms, p_ms, c_ms))]
                print(f"[block] {label} x3, device ms: kernel {k_ms:.4f} ({flops / k_ms / 1e9:.1f} TFLOP/s, "
                      f"{b_ms / k_ms:.1%} of its {b_ms:.4f} ms bound by {by}), plain {p_ms:.4f}, cuDNN "
                      f"conv+bias+ReLU {c_ms:.4f}, kernel/cuDNN {k_ms / c_ms:.3f} | card: {card}", flush=True)
                del x
            k_ms, b_ms, p_ms, c_ms = sums
            print(f"[blocks] {len(blocks)} {name} {net} blocks bs{batch}, device ms: kernel {k_ms:.3f} "
                  f"({b_ms / k_ms:.1%} of the {b_ms:.3f} ms bound), plain {p_ms:.3f}, cuDNN conv+bias+ReLU "
                  f"{c_ms:.3f}, kernel/cuDNN {k_ms / c_ms:.3f} | card: {card}", flush=True)
        from unet_zoo_tpu_torch.models.registry import get_model

        model = get_model("unet", num_classes=2, num_filters=FILTERS, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(0)).eval()
        x = torch.randn((BATCH, IMAGE, IMAGE, 1), generator=gen).to(dev)
        torch.cuda.synchronize()
        start = conv_chain.launches
        model(x)
        torch.cuda.synchronize()
        launched = conv_chain.launches - start
        assert launched == UNET_LAUNCHES, f"the bf16 forward launched the kernel {launched} times"
        ms = device_ms(lambda: model(x), FORWARD_CALLS)
        print(f"[forward] bf16 unet bs{BATCH}: {launched} kernel launches, {ms:.3f} device ms, "
              f"{BATCH / ms * 1e3:.1f} images/s | card: {card}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plans", action="store_true", help="also time other launch plans")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--blocks", action="store_true", help="time whole blocks against plain and cuDNN instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    _build.load()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if args.blocks:
        block_tables(dev, card)
        return 0
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    plan_fn, others = plans_of(dtype)
    plans = {"default": {}, **(others if args.plans else {})}
    batch, blocks = (PROB_BATCH, PROB_BLOCKS) if f32 else (BATCH, BLOCKS)
    peak, itemsize = (PEAK_3XTF32_FLOPS, 4) if f32 else (PEAK_BF16_FLOPS, 2)
    gen = torch.Generator().manual_seed(0)
    stages = [(size, cin, co) for _, size, ci, co in blocks for cin in (ci, co, co)]
    times, total = {}, 0.0
    with torch.inference_mode():
        for size, ci, co in stages:
            x = torch.randn((batch, size, size, ci), generator=gen).to(dev, dtype)
            (k,), (b,) = chain_weights([(ci, co)], gen, dev)
            w = conv_chain.pack_kernel(k, x.dtype)
            for name, choices in plans.items():
                p = plan_fn(tuple(x.shape), co, **choices)
                if p.smem_bytes > conv_chain.SMEM_LIMIT:
                    continue
                small = x[:8].contiguous()  # checked at batch 8 under the full batch's plan
                out = conv_chain._launch_stage(small, w, b, p)
                ref = conv_chain.fused_conv_chain_reference(small, [k], [b])
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = F32_RTOL * scale if f32 else BF16_ULPS * bf16_ulp(scale)
                assert err <= tol, f"{name} {size} {ci}->{co}: max|diff| {err} > {tol}"
                times[(size, ci, co, name)] = min(
                    cuda_ms(lambda: conv_chain._launch_stage(x, w, b, p), 10) for _ in range(2))
            flops, nbytes = chain_cost(batch, size, [(ci, co)], itemsize)
            ms = times[(size, ci, co, "default")]
            total += ms
            bound_ms, by = bound(flops, nbytes, peak)
            p = plan_fn(tuple(x.shape), co)
            tile = f"{p.n_img}x{p.tile_h}x{p.tile_w} tile" if f32 else f"{p.tile_h}x16 tile"
            print(f"[stage] {args.dtype} ({batch}, {size}, {size}, {ci})->{co}: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s, {bound_ms / ms:.1%} of its "
                  f"{bound_ms:.4f} ms bound by {by} | chunk {p.chunk}, N {p.block_n}, {tile}, {p.items} items, "
                  f"halo x{p.halo_stages}, weights {'resident' if p.resident else f'ring x{p.weight_stages}'}, "
                  f"{p.smem_bytes} B, {p.loader} loader | card: {card}", flush=True)
            if args.plans:
                print("        " + ", ".join(f"{name} {times[(size, ci, co, name)]:.4f} ms" for name in plans
                                          if (size, ci, co, name) in times), flush=True)
            del x
    print(f"[stage] {len(stages)} {args.dtype} stages: {total:.3f} ms | card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
