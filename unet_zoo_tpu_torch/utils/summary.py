"""Metrics writer, a jax-free copy of ``unet_zoo_tpu.utils.summary``.

The twin of the reference's TensorBoard ``SummaryWriter`` pair (train and
validation). It always writes a JSONL stream of scalars, and TensorBoard
event files too where ``tensorboardX`` imports; where it does not, the
JSONL stream is all, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

try:
    from tensorboardX import SummaryWriter as _TBWriter
except ImportError:  # pragma: no cover
    _TBWriter = None


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "train", tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"metrics_{name}.jsonl"), "a")
        self._tb = _TBWriter(os.path.join(log_dir, f"tb_{name}")) if (tensorboard and _TBWriter is not None) else None

    @property
    def tensorboard(self) -> bool:
        """Whether TensorBoard events (and so images) are written."""
        return self._tb is not None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))

    def image(self, step: int, tag: str, img) -> None:
        """img: (H, W) or (H, W, C) float array in [0, 1]."""
        if self._tb is not None:
            arr = np.asarray(img, dtype=float)
            arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)  # CHW
            self._tb.add_image(tag, arr, int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
