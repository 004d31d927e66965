"""Train an experiment with the PyTorch port.

    python -m unet_zoo_tpu_torch.train phiseg_7_5_12 [--iterations N] [--log-root DIR] [--device cpu]
"""

import sys

from unet_zoo_tpu_torch.training.cli import train_main

if __name__ == "__main__":
    sys.exit(train_main())
