#!/usr/bin/env python3
"""PHiSeg's sample fold decoded whole and in chunks, on one CUDA card.

    python3 tools/torch_sample_chunks.py [--experiment phiseg_uzh_7_5_512] [--samples 16] [--tf32]

Builds the registered experiment (float32, TF32 off unless ``--tf32``) with
random weights from seed 0 and decodes ``model.sample(x, n)`` of one
synthetic image with n samples, from the same noise, whole and ``chunk``
samples at a time for each chunk in 16, 8, 6, 4, 2 and 1: the wall ms of
the call (after a warm-up call at that chunk) and the peak allocated MiB
above what was allocated before it, and each chunk's logits' max|diff|
from the whole fold's. This is the measurement behind
``Trainer.EVAL_SAMPLE_CHUNK``. Each line carries the card's name and power
limit; the last line is a JSON object of the readings. Exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = (None, 16, 8, 6, 4, 2, 1)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", default="phiseg_uzh_7_5_512")
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--tf32", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_sample_chunks: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from torch_card import card_line

    from unet_zoo_tpu_torch.data import synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    dev = torch.device("cuda", 0)
    card = card_line()
    cfg = get_experiment(args.experiment)
    log_dir = tempfile.mkdtemp(prefix="sample_chunks_")
    model = Trainer(cfg, dev, seed=0, log_dir=log_dir, tensorboard=False, tf32=args.tf32).state.model
    size = cfg.image_size[0]
    x = torch.from_numpy(synthetic.uzh_arrays((1, 1, 1), size, seed=0)["images_test"][:1])[..., None].to(dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa: E731
    rows, whole = [], None
    with torch.inference_mode():
        for chunk in CHUNKS:
            model.sample(x, args.samples, generator=gen(), chunk=chunk)  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            logits = model.sample(x, args.samples, generator=gen(), chunk=chunk)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            whole = logits if chunk is None else whole
            err = (logits - whole).abs().max().item()
            rows.append({"chunk": chunk or args.samples, "whole": chunk is None, "ms": ms, "peak_mib": peak,
                         "max_abs_diff": err})
            print(f"{args.experiment} {size}x{size} sample(x, {args.samples}), {'whole' if chunk is None else chunk} "
                  f"a decode: {ms:.1f} ms, peak {peak:.1f} MiB, logits max|diff| from the whole fold {err:.3e} "
                  f"(max|ref| {whole.abs().max().item():.3e}; TF32 {'on' if args.tf32 else 'off'}) | card: {card}",
                  flush=True)
            del logits
    shutil.rmtree(log_dir, ignore_errors=True)
    print(json.dumps({"experiment": args.experiment, "samples": args.samples, "tf32": args.tf32, "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
