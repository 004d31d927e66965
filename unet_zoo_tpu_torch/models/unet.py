"""U-Net, the twin of ``unet_zoo_tpu.models.unet`` (NHWC), in the three memory modes.

In "plain" and "remat" every down and up block is one fused conv chain
(``ops.ConvSeq``), so on a CUDA device the bf16 forward runs the
hand-written kernel of ``csrc/conv_chain.cu`` 3 times per block: 21
launches for the 7 blocks of the 4-level net, and in "remat" 21 more in the
backward's re-run. In "reversible" (the ``reversible_unet`` experiment)
every block is a ``ReversibleSequence`` whose coupling functions carry
BatchNorm, as in the JAX model, and run as library ops. The 1x1 ``last``
conv and the resizes are library ops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.models.blocks import DownBlock


class UNet(nn.Module):
    """Contracting/expanding conv net with skip concats.

    Up path: bilinear resize (``align_corners=False``) to the skip's exact
    spatial shape, concat ``(upsampled, skip)``, then a 3-conv block.
    ``in_channels`` is explicit here (the JAX model infers it at init).
    Without ``apply_last_layer`` there is no 1x1 ``last`` conv and the
    model returns the up0 features (``num_filters[0]`` channels, in the
    compute dtype), as ProbUNet's trunk. ``train()`` and ``eval()`` stand for the JAX model's ``train`` flag: they
    select BatchNorm's batch or running statistics, which only the
    reversible blocks have.
    """

    def __init__(self, num_classes: int, num_filters: Sequence[int] = (32, 64, 128, 192),
                 in_channels: int = 1, apply_last_layer: bool = True, reversible_mode: str = "plain",
                 dtype: Optional[torch.dtype] = None, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_filters = tuple(num_filters)
        kw = dict(reversible_mode=reversible_mode, dtype=dtype, device=device, generator=generator)
        n = len(self.num_filters)
        c = in_channels
        for i, f in enumerate(self.num_filters):
            self.add_module(f"down{i}", DownBlock(c, f, pool=i != 0, **kw))
            c = f
        for i in range(n - 2, -1, -1):
            f = self.num_filters[i]
            self.add_module(f"up{i}", DownBlock(c + f, f, pool=False, **kw))
            c = f
        self.last = (ops.Conv(c, num_classes, kernel_size=1, init_scheme="torch_default", device=device,
                              generator=generator) if apply_last_layer else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.num_filters)
        skips = []
        for i in range(n):
            x = getattr(self, f"down{i}")(x)
            if i != n - 1:
                skips.append(x)
        for i in range(n - 2, -1, -1):
            x = ops.resize_linear(x, skips[i].shape[1:3], align_corners=False)
            x = getattr(self, f"up{i}")((x, skips[i]))
        return x if self.last is None else self.last(x)

    # the harness contract of the JAX model: loss, sample, accumulate_output

    @staticmethod
    def loss(logits: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean CE over all pixels (torch CrossEntropyLoss default)."""
        loss = softmax_cross_entropy(logits, mask).mean()
        return loss, {"loss": loss, "kl": torch.zeros((), device=loss.device), "recon": loss}

    def sample(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Deterministic model: n identical prediction samples (B, n, ..., C)."""
        logits = self(x)
        return logits[:, None].expand(logits.shape[0], n, *logits.shape[1:])

    @staticmethod
    def accumulate_output(logits: torch.Tensor, use_softmax: bool = False) -> torch.Tensor:
        return torch.softmax(logits, dim=-1) if use_softmax else logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE with integer labels over the trailing channel axis, in f32.

    A gather where the JAX package contracts with a one-hot (a TPU choice);
    the value and the gradient, softmax minus one-hot, are the same."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
