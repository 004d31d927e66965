#!/usr/bin/env python3
"""Repeatability of the port's bf16 conv-chain kernel on one CUDA card.

    python3 tools/torch_conv_chain_repeats.py                 # from the repository root
    python3 tools/torch_conv_chain_repeats.py --repeats 300

The kernel sums in a fixed order, so launches on the same inputs must give
the same bits; a launch that differs from the first shows a race between
the pipeline's producer and its consumers. For each U-Net block (full width,
3 stages, the model's weights from a seed) at batch 512 and 64, and for each
of the 21 stages at batch 512 alone under its own launch plan and the other
plans of ``tools/torch_conv_chain_stages.py --plans``, it launches the
kernel ``--repeats`` times after a first launch and prints how many differ
from the first and by how much at most, beside the card's name and power
limit. Exits 1 if any launch differs, or without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke as smoke  # noqa: E402  (the blocks, the card line)
import torch_conv_chain_stages as stages  # noqa: E402  (the other plans)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=150, help="launches held against the first")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    _build.load()
    model = get_model("unet", num_classes=2, num_filters=smoke.FILTERS, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    total = 0
    with torch.inference_mode():
        for batch in (smoke.BATCH, smoke.TRAIN_BATCH):
            for block, size, ci, co in smoke.BLOCKS:
                convs = [m.conv for m in getattr(model, block).convs.children()]
                ks, bs = [c.weight for c in convs], [c.bias for c in convs]
                x = torch.randn((batch, size, size, ci), generator=gen, device=dev).to(torch.bfloat16)
                packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
                n, worst = differing(lambda: conv_chain.fused_conv_chain(x, ks, bs, packed=packed), args.repeats)
                total += n
                print(f"[block] {block} ({batch}, {size}, {size}, {ci})->{co} x3: {n} of {args.repeats} launches "
                      f"differ from the first, max|diff| {worst:.4g} | card: {card}", flush=True)
        for block, size, ci, co in smoke.BLOCKS:
            convs = [m.conv for m in getattr(model, block).convs.children()]
            for j, c in enumerate(convs):
                shape = (smoke.BATCH, size, size, c.weight.shape[1])
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
