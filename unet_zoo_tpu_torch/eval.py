"""Evaluate a trained experiment with the PyTorch port: the quantitative
test sweep (GED, variance-NCC, Dice) from a checkpoint in its log directory.

    python -m unet_zoo_tpu_torch.eval phiseg_7_5_12 [--checkpoint best_loss] [--device cpu]
"""

import sys

from unet_zoo_tpu_torch.training.cli import eval_main

if __name__ == "__main__":
    sys.exit(eval_main())
