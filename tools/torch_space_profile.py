#!/usr/bin/env python3
"""Where a spatially sharded step's time goes, on one CUDA card.

    python3 tools/torch_space_profile.py    # from the repository root

Starts two processes that share the card over gloo on a space-2 mesh (one
data group, its image height split in two), as ``chip_smoke.py`` phase 14
does, and prints from each: the ms of one halo exchange of a (64, 64, 128,
32) bf16 activation (mean of 50 after 5), the ms of three bf16 ``unet``
train steps at bs64 128x128 (the first builds everything), and from the
first process ``torch.profiler``'s tables of a fourth step, by host time
and by device time, beside the card's name and power limit. The processes
are killed after 240 seconds. Before them, on the card alone: the ms of
the width resize that a space-2 U-Net step's last upsample makes, a (64,
64, 64, 64) bf16 activation to 128 columns forward and backward, as
``F.interpolate``'s 1D linear kernel on the height folded into the batch
and as ``space.resize_axis``'s matrix product (mean of 5 after 1). Exits 1
without a card.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIMEOUT = 240


def worker(rank: int, port: str) -> None:
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh
    from unet_zoo_tpu_torch.parallel.space import space_sharding
    from unet_zoo_tpu_torch.training import Trainer

    init_distributed(f"127.0.0.1:{port}", 2, rank, device="cuda", backend="gloo")
    mesh = make_mesh(space=2)
    dev = mesh.device
    torch.cuda.set_per_process_memory_fraction(chip_smoke.SPACE_MEMORY_FRACTION, dev)
    x = torch.randn(64, 64, 128, 32, device=dev, dtype=torch.bfloat16)
    with space_sharding(mesh) as sp:
        for n in (5, 50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                sp.halo(x)
            torch.cuda.synchronize()
        halo_ms = (time.perf_counter() - t0) / 50 * 1e3
    print(f"[{rank}] halo of (64, 64, 128, 32) bf16: {halo_ms:.3f} ms a call", flush=True)
    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=64)
    xs, ys = chip_smoke.train_batches(4, dev)
    with tempfile.TemporaryDirectory() as log_dir:
        tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(xs[i], ys[i])
            torch.cuda.synchronize()
            print(f"[{rank}] step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.train_step(xs[3], ys[3])
            torch.cuda.synchronize()
    if rank == 0:
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=30), flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)
        print(chip_smoke.card_line(), flush=True)


def width_resize_ms() -> None:
    """The two routes of the width resize (module docstring), each timed by events."""
    import torch.nn.functional as F

    import chip_smoke
    from unet_zoo_tpu_torch.parallel.space import resize_axis

    x = torch.randn(64, 64, 64, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    routes = {
        "F.interpolate, height folded into the batch": lambda: F.interpolate(
            x.reshape(-1, 64, 64).movedim(-1, 1), size=128, mode="linear", align_corners=False),
        "space.resize_axis": lambda: resize_axis(x, 2, 128, "linear", False),
    }
    for name, route in routes.items():
        ms = chip_smoke.cuda_ms(lambda: route().float().sum().backward(), 5)
        print(f"width resize (64, 64, 64, 64) bf16 -> 128 columns, forward and backward, {name}: {ms:.3f} ms",
              flush=True)
    print(chip_smoke.card_line(), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_space_profile: needs a CUDA card", file=sys.stderr)
        return 1
    width_resize_ms()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), port]) for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.wait() for p in procs]
    print("exit codes", codes)
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), sys.argv[2])
        sys.exit(0)
    sys.exit(main())
