#!/usr/bin/env python3
"""Where the PHiSeg train step's time goes, on one CUDA card.

    python3 tools/torch_phiseg_profile.py [--steps N]    # from the repository root
    python3 tools/torch_phiseg_profile.py --experiment phiseg_uzh_7_5_512 --dtype float32 [--tf32] --steps 2

Builds the ``phiseg_7_5_12`` trainer in bf16 (batch 12, 128x128, device
augmentation) from seed 0, or another registered PHiSeg experiment in
either dtype with cuDNN's TF32 off (the ``Trainer``'s default) or on (a UZH
experiment on ``synthetic.uzh_arrays`` at its size, 3 classes), warms up,
then prints: the step's time by CUDA
events (min of 2 rounds of N steps) and images/s; the host's time to issue
one step onto an idle device (min and median of N); and, from
``torch.profiler`` over 3 steps, the kernel time a step, the kernel launches
a step, the device's busy share of the profiled wall time, and the ops that
take the most host and device time. Each timed line carries the card's name
and power limit. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED_STEPS = 3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--experiment", default="phiseg_7_5_12")
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    parser.add_argument("--tf32", action="store_true", help="cuDNN convolutions and f32 matmuls in TF32")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, cuda_ms, train_batches
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    dev = torch.device("cuda", 0)
    card = card_line()
    cfg = dataclasses.replace(get_experiment(args.experiment), dtype=args.dtype)
    if cfg.data_loader == "uzh_prostate":
        from unet_zoo_tpu_torch.data import UZHProstateData, synthetic

        data = UZHProstateData(synthetic.uzh_arrays((cfg.batch_size, 0, 0), cfg.image_size[0], seed=0), seed=0)
        xs, ys = ([torch.from_numpy(a).to(dev)] for a in data.train.next_batch(cfg.batch_size))
    else:
        xs, ys = train_batches(1, dev, cfg.batch_size)
    trainer = Trainer(cfg, dev, seed=0, log_dir=tempfile.mkdtemp(prefix="phiseg_profile_"), tensorboard=False,
                      tf32=args.tf32)
    print(f"[profile] {args.experiment} {args.dtype}, TF32 {'on' if args.tf32 else 'off'}, batch {cfg.batch_size}, "
          f"{'x'.join(map(str, cfg.image_size))}", flush=True)
    for _ in range(3):
        trainer.train_step(xs[0], ys[0])

    step_ms = min(cuda_ms(lambda: trainer.train_step(xs[0], ys[0]), args.steps) for _ in range(2))
    hosts = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(xs[0], ys[0])
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    print(f"[time] step {step_ms:.3f} ms, {cfg.batch_size / step_ms * 1e3:.1f} images/s; host issue min / median "
          f"{min(hosts):.3f} / {sorted(hosts)[len(hosts) // 2]:.3f} ms | card: {card}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            trainer.train_step(xs[0], ys[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED_STEPS
    launches = sum(e.count for e in kernels) / PROFILED_STEPS
    print(f"[profile] a step: {kernel_ms:.3f} ms of kernels in {wall_ms:.3f} ms of profiled wall time (device busy "
          f"{kernel_ms / wall_ms:.1%}), {launches:.0f} kernels | card: {card}")
    print(events.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
