#!/usr/bin/env python3
"""Per-stage times of the port's bf16 conv-chain kernel on one CUDA card.

    python3 tools/torch_conv_chain_stages.py            # from the repository root
    python3 tools/torch_conv_chain_stages.py --plans    # also time other launch plans

For each of the 21 stages of the U-Net's main path (7 blocks x 3 stages, full
width, batch 512, random weights from a seed) it prints the launch plan, the
kernel's time (CUDA events, min of 2 rounds of 10 launches), its TFLOP/s,
the bytes/s of the stage's own input and output, and the share of the
stage's bound (the larger of its FLOPs at the bf16 peak and those bytes at
the memory rate), beside the card's name and power limit. ``--plans`` times
each stage again under a few other plans (4-row tiles, two halo stages,
weights in a ring rather than resident), after checking each against the
plain version. Exits non-zero without a card.
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


# the other plans of --plans: launch_plan's own choice replaced by these
PLANS = {"4-row tiles": dict(tile_h=4), "2 halo stages": dict(halo_stages=2),
         "weights in a ring": dict(resident=False)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plans", action="store_true", help="also time other launch plans")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    _build.load()
    plans = {"default": {}, **(PLANS if args.plans else {})}
    gen = torch.Generator().manual_seed(0)
    stages = [(size, cin, co) for _, size, ci, co in smoke.BLOCKS for cin in (ci, co, co)]
    times, total = {}, 0.0
    with torch.inference_mode():
        for size, ci, co in stages:
            x = torch.randn((BATCH, size, size, ci), generator=gen).to(dev, torch.bfloat16)
            (k,), (b,) = smoke.chain_weights([(ci, co)], gen, dev)
            w = conv_chain.pack_kernel(k, x.dtype)
            for name, choices in plans.items():
                p = conv_chain.launch_plan(tuple(x.shape), co, **choices)
                if p.smem_bytes > conv_chain.SMEM_LIMIT:
                    continue
                small = x[:8].contiguous()  # checked at batch 8 under the batch-512 plan
                out = conv_chain._launch_stage(small, w, b, p)
                ref = conv_chain.fused_conv_chain_reference(small, [k], [b])
                err = (out.float() - ref.float()).abs().max().item()
                tol = smoke.BF16_ULPS * smoke.bf16_ulp(ref.float().abs().max().item())
                smoke.check(err <= tol, f"{name} {size} {ci}->{co}: max|diff| {err} > {tol}")
                times[(size, ci, co, name)] = min(
                    smoke.cuda_ms(lambda: conv_chain._launch_stage(x, w, b, p), 10) for _ in range(2))
            flops, nbytes = smoke.chain_cost(BATCH, size, [(ci, co)])
            ms = times[(size, ci, co, "default")]
            total += ms
            bound_ms, by = smoke.bound(flops, nbytes)
            p = conv_chain.launch_plan(tuple(x.shape), co)
            print(f"[stage] ({BATCH}, {size}, {size}, {ci})->{co}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / ms / 1e9:.3f} TB/s, {bound_ms / ms:.1%} of its {bound_ms:.3f} ms bound by {by} | "
                  f"chunk {p.chunk}, N {p.block_n}, {p.tile_h}x16 tile, halo x{p.halo_stages}, "
                  f"weights {'resident' if p.resident else f'ring x{p.weight_stages}'}, {p.smem_bytes} B, "
                  f"{p.loader} loader | card: {card}", flush=True)
            if args.plans:
                print("        " + ", ".join(f"{name} {times[(size, ci, co, name)]:.3f} ms" for name in plans
                                          if (size, ci, co, name) in times), flush=True)
            del x
    print(f"[stage] 21 stages: {total:.3f} ms | card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
