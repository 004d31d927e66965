#!/usr/bin/env python3
"""Spatial sharding on four cards over NCCL: the card test's processes, one a card.

    python3 tools/torch_space_nccl.py [--timeout S]    # from the repository root, on 4 cards

``tests/test_torch_space_card.py`` runs its space-2 mesh as two processes
sharing one card over gloo, which says nothing of NCCL or of its speed. This
script starts the same processes (``tests/torch_space_card_worker.py``), one
a card over NCCL, on a data=2, space=2 mesh: each data group's images split
in height over two cards, the halos sent to the neighbours by
``batch_isend_irecv``. It holds (a) the bf16 ``unet`` step (global batch
64, 128x128) and (b) the registered ``phiseg_uzh_7_5_512`` step (f32, TF32
off, global batch 12) against one process's step on the global batch on
card 0 from the same state and draws, at the card test's gates, and (c)
the ``dryrun_multichip`` twin. The processes are killed after ``--timeout``
seconds (300); a process that fails or is killed has the end of its output
printed. A failed gate raises; the last line is the card's name and power
limit. Exits 1 without four cards.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

WORLD = 4


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_space_nccl: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    import torch_space_card_worker as worker
    from torch_card import card_line
    from unet_zoo_tpu_torch.ops.pallas import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="space_nccl_") as workdir:
        ranks = worker.spawn(workdir, WORLD, "nccl", args.timeout)
        worker.unet_checks(dev, ranks, workdir)
        worker.uzh_checks(dev, ranks, workdir)
        worker.dryrun_checks(ranks)
    print(f"[space] {WORLD} processes over NCCL, one a card, data 2 x space 2: (a)-(c) hold | card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
