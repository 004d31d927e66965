#!/usr/bin/env python3
"""Peak device memory of a train step in each memory mode, on one CUDA card.

    python3 tools/torch_memory.py    # from the repository root

The PyTorch twin of ``bench_memory.py``: the full train step (device
augmentation, forward, loss, backward, coupled-L2 Adam, plateau LR) of
``phiseg_7_5_12``'s shape (filters 32/64/128/192/192/192/192, 5 latent
levels, 128x128x1) in float32 at batch 12 and 24, of the ``unet``
experiment's shape at batch 64, and of ``phiseg_brats`` (PHiSeg3D, filters
32/64/128, 2 latent levels, 128^3x4, one-hot WT/TC/ET labels, its 3D
augmentation) at batch 1, each in "plain", "remat" and "reversible": the
RevPHiSeg memory claim measured at 128^3.
Each cell runs twice: with cuDNN's TF32 off (strict float32, the parity
setting of ``chip_smoke.py``) and on (PyTorch's default for cuDNN
convolutions). With TF32 off cuDNN picks algorithms for PHiSeg's 128x128
post-c convolutions (224 -> 128 channels) that take a transient workspace
of up to ~16 GiB, which then sets the step's peak in every mode but the
reversible one. For each cell: a warm-up step (which allocates Adam's
moments and the library's workspaces), then the peak of
``torch.cuda.max_memory_allocated`` over one more step after
``reset_peak_memory_stats``, beside the state's own bytes (parameters,
running statistics, Adam's moments) and the saving against "plain" at the
same model, batch and TF32 setting. Every line carries the card's name and
power limit. Exits 1 without a card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("plain", "remat", "reversible")
# (experiment, batch): the cells of the table
CELLS = (("phiseg_7_5_12", 12), ("phiseg_7_5_12", 24), ("unet", 64), ("phiseg_brats", 1))
MIB = 2 ** 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def memory_table(dev, card: str, log=print) -> list:
    """Every cell in every mode, with TF32 off and on; prints one line a
    cell and returns the rows. Leaves both TF32 flags as it found them."""
    rows = []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        with tempfile.TemporaryDirectory(prefix="torch_memory_") as log_dir:
            for allow in (False, True):
                for experiment, batch in CELLS:
                    plain = None
                    for mode in MODES:
                        row = {**step_peak(experiment, mode, batch, dev, log_dir, allow), "tf32": allow}
                        plain = plain or row["peak_bytes"]
                        row["saving_vs_plain"] = 1.0 - row["peak_bytes"] / plain
                        rows.append(row)
                        log(f"[memory] {experiment} f32 (TF32 {'on' if allow else 'off'}) bs{batch} {mode:<10}: "
                            f"step peak {row['peak_bytes'] / MIB:9.1f} MiB (state {row['state_bytes'] / MIB:6.1f} "
                            f"MiB, allocated between steps {row['base_bytes'] / MIB:6.1f} MiB), saving against "
                            f"plain {row['saving_vs_plain']:6.1%} | card: {card}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    memory_table(torch.device("cuda", 0), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
