#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` over NCCL: spatial sharding on four cards.

    python3 tools/torch_space_nccl.py [--timeout S]    # from the repository root, on 4 cards

``chip_smoke.py`` phase 14 runs its space-2 mesh as two processes sharing
one card over gloo, which says nothing of NCCL or of its speed. This
script runs the same processes (``chip_smoke.space_worker``), one a card
over NCCL, on a data=2, space=2 mesh: each data group's images split in
height over two cards, the halos sent to the neighbours by
``batch_isend_irecv``. It holds (a) the bf16 ``unet`` step (global batch
64, 128x128) and (b) the registered ``phiseg_uzh_7_5_512`` step (f32, TF32
off, global batch 12) against one process's step on the global batch on
card 0 from the same state and draws, at phase 14's gates, with each
process's ms a step and peak MiB, and (c) the ``dryrun_multichip`` twin.
The processes are killed after ``--timeout`` seconds (300); a process that
fails or is killed has the end of its output printed.
Prints a line a reading with the card's name and power limit, and them
all as one JSON object last. Exits 1 without four cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORLD = 4


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--timeout", type=float, default=300.0)
    args = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_space_nccl: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    import chip_smoke
    from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    with tempfile.TemporaryDirectory(prefix="space_nccl_") as workdir:
        ranks, spawn_s = chip_smoke.spawn_space(workdir, WORLD, "nccl", args.timeout)
        mesh = f"{WORLD} processes over NCCL, one a card, data 2 x space 2"
        chip_smoke.log(f"[space] {mesh} ran (a)-(c) in {spawn_s:.1f} s | card: {card}")
        result = {"spawn_s": spawn_s, **chip_smoke.space_checks(conv_chain, dev, card, ranks, workdir, mesh)}
    chip_smoke.log(card)
    chip_smoke.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
