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
Each cell runs twice: with cuDNN's TF32 off (strict float32, the setting
of the card tests' ``card`` fixture, ``tests/torch_card.py``) and on
(PyTorch's default for cuDNN convolutions). With TF32 off cuDNN picks algorithms for PHiSeg's 128x128
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

import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from torch_card import MEMORY_MODES, MIB, card_line, step_peak  # noqa: E402

# (experiment, batch): the cells of the table
CELLS = (("phiseg_7_5_12", 12), ("phiseg_7_5_12", 24), ("unet", 64), ("phiseg_brats", 1))


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
                    for mode in MEMORY_MODES:
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
    memory_table(torch.device("cuda", 0), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
