#!/usr/bin/env python3
"""Per-stage times of the port's conv-chain kernel on one CUDA card.

    python3 tools/torch_conv_chain_stages.py                    # from the repository root
    python3 tools/torch_conv_chain_stages.py --plans            # also time other launch plans
    python3 tools/torch_conv_chain_stages.py --dtype float32    # the f32 kernel at ProbUNet's stages

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
ring), after checking each against the plain version. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (the card's peaks, the blocks, the timing helpers)
from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain  # noqa: E402

BATCH = 512
F32_BATCH = smoke.PROB_BATCH


# the other plans of --plans: launch_plan's (bf16) or f32_launch_plan's own
# choice replaced by these
PLANS = {"4-row tiles": dict(tile_h=4), "2 halo stages": dict(halo_stages=2),
         "weights in a ring": dict(resident=False)}
F32_PLANS = {"one warpgroup": dict(warpgroups=1), "32 channels a block": dict(block_n=32),
             "weights in a ring": dict(resident=False)}


def plans_of(dtype: torch.dtype) -> tuple:
    """(the plan function, the other plans of --plans) of a dtype's kernel."""
    if dtype == torch.float32:
        return conv_chain.f32_launch_plan, F32_PLANS
    return conv_chain.launch_plan, PLANS


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plans", action="store_true", help="also time other launch plans")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    _build.load()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    f32 = dtype == torch.float32
    plan_fn, others = plans_of(dtype)
    plans = {"default": {}, **(others if args.plans else {})}
    batch, blocks = (F32_BATCH, smoke.PROB_BLOCKS) if f32 else (BATCH, smoke.BLOCKS)
    peak, itemsize = (smoke.PEAK_3XTF32_FLOPS, 4) if f32 else (smoke.PEAK_BF16_FLOPS, 2)
    gen = torch.Generator().manual_seed(0)
    stages = [(size, cin, co) for _, size, ci, co in blocks for cin in (ci, co, co)]
    times, total = {}, 0.0
    with torch.inference_mode():
        for size, ci, co in stages:
            x = torch.randn((batch, size, size, ci), generator=gen).to(dev, dtype)
            (k,), (b,) = smoke.chain_weights([(ci, co)], gen, dev)
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
                tol = smoke.F32_RTOL * scale if f32 else smoke.BF16_ULPS * smoke.bf16_ulp(scale)
                smoke.check(err <= tol, f"{name} {size} {ci}->{co}: max|diff| {err} > {tol}")
                times[(size, ci, co, name)] = min(
                    smoke.cuda_ms(lambda: conv_chain._launch_stage(x, w, b, p), 10) for _ in range(2))
            flops, nbytes = smoke.chain_cost(batch, size, [(ci, co)], itemsize)
            ms = times[(size, ci, co, "default")]
            total += ms
            bound_ms, by = smoke.bound(flops, nbytes, peak)
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
