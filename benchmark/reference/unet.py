"""U-Net (Ronneberger et al., 2015), the reference, as UNet-Zoo's
``models/unet.py`` and its experiment ``unet.py`` build it: ``len(filters)``
levels of 3 conv + ReLU without normalisation (He-normal kernels), a 2x2
average pool before each but the first; up the path a bilinear resize
(corners not aligned) to the skip, the resized features then the skip
concatenated, 3 conv + ReLU; a 1x1 ``last`` conv. The loss is the mean
cross-entropy over every pixel. NCHW float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.reference import ops

DEPTH = 3

# the benchmark's tests' size: two levels, 16x16
TINY = dict(filter_channels=(4, 8), image_size=(16, 16))


class Model:
    def __init__(self, filters: Sequence[int], classes: int, image_size: Sequence[int], in_channels: int = 1):
        self.f = tuple(filters)
        self.C = classes
        self.image_size = tuple(image_size)
        self.in_channels = in_channels

    def blocks(self) -> List[Tuple[str, int, int]]:
        """(name, C_in, C_out) of each 3-conv block, down then up."""
        out, c = [], self.in_channels
        for i, fi in enumerate(self.f):
            out.append((f"down{i}", c, fi))
            c = fi
        for i in range(len(self.f) - 2, -1, -1):
            out.append((f"up{i}", c + self.f[i], self.f[i]))
            c = self.f[i]
        return out

    def block_sizes(self) -> Dict[str, tuple]:
        """Spatial size of each block."""
        sizes = [self.image_size]
        for _ in range(len(self.f) - 1):
            sizes.append(tuple(-(-s // 2) for s in sizes[-1]))
        return {name: sizes[int(name[-1])] for name, _, _ in self.blocks()}

    def specs(self) -> List[Tuple[str, tuple, tuple]]:
        """(path, shape, init): ("he_normal", std) kernels with ("trunc_normal",
        1e-3) biases in the blocks, ("uniform", bound) for ``last``."""
        out = []
        for name, ci, co in self.blocks():
            for i in range(DEPTH):
                cin = ci if i == 0 else co
                out.append((f"{name}.convs.conv{i}.conv.weight", (co, cin, 3, 3), ("he_normal", (2.0 / (9 * cin)) ** 0.5)))
                out.append((f"{name}.convs.conv{i}.conv.bias", (co,), ("trunc_normal", 1e-3)))
        bound = 1.0 / self.f[0] ** 0.5
        out.append(("last.weight", (self.C, self.f[0], 1, 1), ("uniform", bound)))
        out.append(("last.bias", (self.C,), ("uniform", bound)))
        return out

    def forward(self, p, x: torch.Tensor) -> torch.Tensor:
        n = len(self.f)
        skips = []
        for i in range(n):
            if i:
                x = ops.avg_pool(x)
            x = ops.conv_relu_seq(p, f"down{i}.convs", x, DEPTH)
            if i != n - 1:
                skips.append(x)
        for i in range(n - 2, -1, -1):
            x = ops.resize(x, skips[i].shape[2:], align_corners=False)
            x = ops.conv_relu_seq(p, f"up{i}.convs", torch.cat([x, skips[i]], 1), DEPTH)
        return ops.conv(p, "last", x)

    def noise_shapes(self, batch: int) -> list:
        """None: the model is deterministic, and no noise is drawn for it."""
        return []

    def step_loss(self, p, bufs, x, mask, z_eps=None, train: bool = True) -> Dict[str, torch.Tensor]:
        return self.loss(self.forward(p, x), mask)

    def sample(self, p, bufs, x, n: int, eps=None) -> torch.Tensor:
        """n equal predictions: the model is deterministic."""
        return self.forward(p, x).expand(n, -1, -1, -1)

    def loss(self, logits: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss = ops.pixel_ce(logits, mask).mean()
        return {"loss": loss, "kl": torch.zeros_like(loss), "recon": loss}


def build(exp: dict, overrides: Optional[dict] = None) -> Model:
    """The model of a configuration's ``experiment`` block."""
    e = {**exp, **(overrides or {})}
    return Model(e["filter_channels"], e["n_classes"], e["image_size"], e["input_channels"])
