#!/usr/bin/env python3
"""Repeatability of the port's conv-chain kernel on one CUDA card.

    python3 tools/torch_conv_chain_repeats.py                 # from the repository root
    python3 tools/torch_conv_chain_repeats.py --repeats 300
    python3 tools/torch_conv_chain_repeats.py --dtype float32

The kernel sums in a fixed order, so launches on the same inputs must give
the same bits; a launch that differs from the first shows a race between
the pipeline's producer and its consumers. bfloat16 (the default): for each
U-Net block (full width, 3 stages, the model's weights from a seed) at batch
512 and 64, and for each of the 21 stages at batch 512 alone under its own
launch plan and the other plans of ``tools/torch_conv_chain_stages.py
--plans``. float32: for each of ProbUNet's 13 trunk blocks (random weights
from a seed) at batches 1, 12 and 16, and for each of its 39 stages at batch
12 under its own plan and the other f32 plans. Each is launched
``--repeats`` times after a first launch; it prints how many differ from
the first and by how much at most, beside the card's name and power limit.
Exits 1 if any launch differs, or without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools"), os.path.join(REPO, "tests")]

import torch_conv_chain_stages as stages  # noqa: E402  (the other plans)
from torch_card import (BATCH, BLOCKS, FILTERS, PROB_BATCH, PROB_BLOCKS, PROB_CHECK_BATCHES, TRAIN_BATCH,  # noqa: E402
                        block_chans, card_line, chain_weights)
from unet_zoo_tpu_torch.models.registry import get_model  # noqa: E402
from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain  # noqa: E402


def differing(launch, repeats: int) -> tuple:
    """(launches of ``repeats`` that differ from a first one, max |diff|)."""
    first = launch()
    count, worst = 0, 0.0
    for _ in range(repeats):
        out = launch()
        if not torch.equal(out, first):
            count += 1
            worst = max(worst, (out.float() - first.float()).abs().max().item())
    return count, worst


def f32_repeats(dev, card: str, repeats: int) -> int:
    """The float32 kernel's blocks and stages (see the module docstring);
    returns the launches that differ from their first."""
    gen = torch.Generator().manual_seed(1)
    total = 0
    with torch.inference_mode():
        for block, size, ci, co in PROB_BLOCKS:
            chans = block_chans(ci, co)
            ks, bs = chain_weights(chans, gen, dev)
            packed = [conv_chain.pack_kernel(k, torch.float32) for k in ks]
            for batch in PROB_CHECK_BATCHES:
                x = torch.randn((batch, size, size, ci), generator=gen).to(dev)
                n, worst = differing(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), repeats)
                total += n
                print(f"[block] f32 {block} ({batch}, {size}, {size}, {ci})->{co} x3: {n} of {repeats} launches "
                      f"differ from the first, max|diff| {worst:.4g} | card: {card}", flush=True)
            for j, (c_in, c_out) in enumerate(chans):
                shape = (PROB_BATCH, size, size, c_in)
                x = torch.relu(torch.randn(shape, generator=gen).to(dev))
                reads = []
                for name, choices in {"own plan": {}, **stages.F32_PLANS}.items():
                    p = conv_chain.f32_launch_plan(shape, c_out, **choices)
                    n, worst = differing(lambda: conv_chain._launch_stage(x, packed[j], bs[j], p), repeats)
                    total += n
                    reads.append(f"{name} {n} ({worst:.4g})")
                print(f"[stage] f32 {block} stage {j + 1} {shape}->{c_out}: launches of {repeats} that differ "
                      f"(max|diff|): {', '.join(reads)} | card: {card}", flush=True)
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=150, help="launches held against the first")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    _build.load()
    if args.dtype == "float32":
        total = f32_repeats(dev, card, args.repeats)
        print(f"[repeats] {total} float32 launches differ from their first | card: {card}")
        return 1 if total else 0
    model = get_model("unet", num_classes=2, num_filters=FILTERS, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    total = 0
    with torch.inference_mode():
        for batch in (BATCH, TRAIN_BATCH):
            for block, size, ci, co in BLOCKS:
                convs = [m.conv for m in getattr(model, block).convs.children()]
                ks, bs = [c.weight for c in convs], [c.bias for c in convs]
                x = torch.randn((batch, size, size, ci), generator=gen, device=dev).to(torch.bfloat16)
                packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
                n, worst = differing(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), args.repeats)
                total += n
                print(f"[block] {block} ({batch}, {size}, {size}, {ci})->{co} x3: {n} of {args.repeats} launches "
                      f"differ from the first, max|diff| {worst:.4g} | card: {card}", flush=True)
        for block, size, ci, co in BLOCKS:
            convs = [m.conv for m in getattr(model, block).convs.children()]
            for j, c in enumerate(convs):
                shape = (BATCH, size, size, c.weight.shape[1])
                x = torch.relu(torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
                w = conv_chain.pack_kernel(c.weight, x.dtype)
                reads = []
                for name, choices in {"own plan": {}, **stages.PLANS}.items():
                    p = conv_chain.launch_plan(shape, c.weight.shape[0], **choices)
                    if p.smem_bytes > conv_chain.SMEM_LIMIT:
                        continue
                    n, worst = differing(lambda: conv_chain._launch_stage(x, w, c.bias, p), args.repeats)
                    total += n
                    reads.append(f"{name} {n} ({worst:.4g})")
                print(f"[stage] {block} stage {j + 1} {shape}->{c.weight.shape[0]}: launches of {args.repeats} that "
                      f"differ (max|diff|): {', '.join(reads)} | card: {card}", flush=True)
                del x
    print(f"[repeats] {total} launches differ from their first | card: {card}")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
