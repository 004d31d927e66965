"""Post-processing of label maps on the host, a copy of the part of
``unet_zoo_tpu.utils.postprocess`` that the BraTS export uses (the
reference's ``BratsProcessing/utils.py``), with connected components from
``scipy.ndimage.label``."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def keep_largest_connected_components(mask: np.ndarray) -> np.ndarray:
    """Keep, for each foreground label, only its largest connected component
    (face connectivity); the first of equal sizes wins."""
    out = np.zeros_like(mask)
    for lbl in np.unique(mask):
        if lbl == 0:
            continue
        binary = mask == lbl
        labeled, n = ndimage.label(binary)
        if n == 0:
            continue
        sizes = ndimage.sum(binary, labeled, range(1, n + 1))
        out[labeled == 1 + int(np.argmax(sizes))] = lbl
    return out


def convert_to_onehot(labels: np.ndarray, nlabels: int) -> np.ndarray:
    """Integer label map -> channel-last float32 one-hot."""
    return np.eye(nlabels, dtype=np.float32)[labels.astype(np.int64)]
