#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (spatial sharding) alone, on one CUDA card.

    python3 tools/torch_space_phase.py    # from the repository root

Builds the kernels, then runs ``chip_smoke.space_phase`` as the whole
script runs it, with cuDNN's and the matmuls' TF32 off: the halo tiles
against the unsplit kernel, then SPACE_RANKS processes sharing the card over
gloo for (a)-(c), at the script's gates. Prints the phase's lines, then its
results (without the per-block tile rows) as one JSON object. A failed gate
raises. Exits 1 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_space_phase: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    with tempfile.TemporaryDirectory(prefix="space_phase_") as log_root:
        result = chip_smoke.space_phase(conv_chain, dev, card, log_root)
    result.pop("tiles")
    chip_smoke.log(card)
    chip_smoke.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
