#!/usr/bin/env python3
"""The float32 conv chain's kernel against cuDNN, in the U-Net train step on one CUDA card.

    python3 tools/torch_f32_route.py [--steps N] [--batch B]    # from the repository root

Times the float32 ``unet`` train step (batch 12 by default, 128x128x1, the
experiment's device augmentation, coupled-L2 Adam, plateau LR) three ways:
as the port runs it, every block on the hand-written float32 kernel
(``conv3x3_f32_3xtf32_wgmma``: 3xTF32 on the tensor cores, f32-level
error; with cuDNN's conv gradients, TF32 off as ``Trainer`` sets it); and, as
yardsticks the port never takes, every block on the chain's plain version,
whose convs are cuDNN's, in float32 with TF32 off and with TF32 on. Each is
also held against the same weights on the CPU: the float32 forward of two
images (max|diff| over max|ref|, beside the 1e-4 gate of ``chip_smoke.py``
phase 3). Times are CUDA events, the min of 2 rounds of N steps after a
warm-up step; each line carries the card's name and power limit. Exits 1
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_GATE = 1e-4  # chip_smoke.py phase 3: max|diff| <= 1e-4 * max|ref|


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def route(name: str):
    """Runs every ``ConvSeq`` chain on ``name``: "kernel" (the port as it
    is) or "cudnn"/"tf32" (the chain's plain version in place of the
    kernel's wrapper, TF32 off/on)."""
    from unet_zoo_tpu_torch.ops import conv
    from unet_zoo_tpu_torch.ops.pallas import conv_chain

    def plain(x, kernels, biases, packed=None):
        return conv_chain.fused_conv_chain_reference(x, kernels, biases)

    torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        with contextlib.nullcontext() if name == "kernel" else mock.patch.object(conv, "fused_conv_chain", plain):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, card = torch.device("cuda", 0), card_line()
    cfg = dataclasses.replace(get_experiment("unet"), batch_size=args.batch)
    assert cfg.dtype == "float32"
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((args.batch, 128, 128, 1), generator=gen, device=dev)
    y = (torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4) > 0)[:, 0].long()
    x2 = torch.randn((2, 128, 128, 1), generator=torch.Generator().manual_seed(2))
    kw = dict(num_classes=2, num_filters=cfg.filter_channels, generator=torch.Generator().manual_seed(0))
    m_cpu = get_model("unet", device="cpu", **kw).eval()
    with torch.inference_mode():
        want = m_cpu(x2)
    results = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for name in ("kernel", "cudnn", "tf32"):
            with route(name):
                m_gpu = get_model("unet", device=dev, **{**kw, "generator": torch.Generator().manual_seed(0)}).eval()
                with torch.inference_mode():
                    err = ((m_gpu(x2.to(dev)).cpu() - want).abs().max() / want.abs().max()).item()
                trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir, tf32=name == "tf32")
                trainer.train_step(x, y)
                torch.cuda.synchronize()
                conv_chain.launches = 0
                trainer.train_step(x, y)
                torch.cuda.synchronize()
                launches = conv_chain.launches
                best = float("inf")
                for _ in range(2):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.steps):
                        trainer.train_step(x, y)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / args.steps)
                results[name] = {"ms": best, "images_s": args.batch / best * 1e3, "launches": launches,
                                 "forward_err_of_max": err, "holds_f32_gate": err <= F32_GATE}
                print(f"[f32 route] {name:<6} ({trainer.chain_route if name == 'kernel' else 'plain chain'}) unet "
                      f"f32 train step bs{args.batch}: {best:.3f} ms, "
                      f"{args.batch / best * 1e3:.1f} images/s, {launches} conv-chain launches a step; f32 forward "
                      f"vs CPU {err:.3e} of max|ref| (gate {F32_GATE}: {'holds' if err <= F32_GATE else 'fails'}) "
                      f"| card: {card}", flush=True)
                del trainer, m_gpu
                torch.cuda.empty_cache()
    print(json.dumps({"f32_route": results, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
