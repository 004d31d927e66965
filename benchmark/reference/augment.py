"""The LIDC augmentation's warp, the reference (UNet-Zoo's
``utils.augmentation_function`` as the experiments configure it: rotation,
scale-crop, left/right and up/down flips), given each image's draws.

Per image, under its gate: the destination grid mapped back to the source
through the scale-crop (a square of side ``r`` at ``(off_r, off_c)``
resized to the image) and then the rotation by ``angle`` degrees about the
centre; the image and the one-hot label sampled bilinearly from the source
with a zero border, the label taken back by argmax. Then each flip under its
own coin. NHWC images (B, H, W, 1) and labels (B, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _sample(src: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of src (B, H, W, K) at (B, H, W) coordinates, 0 outside."""
    b, h, w, k = src.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = (rows - r0)[..., None], (cols - c0)[..., None]
    flat = src.reshape(b, h * w, k)

    def tap(r, c):
        r, c = r.long(), c.long()
        inside = ((r >= 0) & (r < h) & (c >= 0) & (c < w))[..., None]
        idx = (r.clamp(0, h - 1) * w + c.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, k)
        return torch.gather(flat, 1, idx).reshape(b, *rows.shape[1:], k) * inside

    top = (1 - fr) * tap(r0, c0) + fr * tap(r0 + 1, c0)
    bottom = (1 - fr) * tap(r0, c0 + 1) + fr * tap(r0 + 1, c0 + 1)
    return (1 - fc) * top + fc * bottom


def warp(images: torch.Tensor, labels: torch.Tensor, draws: dict, classes: int):
    """``draws``: gate, angle (degrees), r, off_r, off_c, flip_lr, flip_ud, each (B,)."""
    b, h, w, c = images.shape
    rows = torch.arange(h, dtype=torch.float32, device=images.device).view(1, h, 1).expand(b, h, w)
    cols = torch.arange(w, dtype=torch.float32, device=images.device).view(1, 1, w).expand(b, h, w)
    r = draws["r"].float().view(-1, 1, 1)
    rows = (rows + 0.5) * (r / h) - 0.5 + draws["off_r"].float().view(-1, 1, 1)
    cols = (cols + 0.5) * (r / w) - 0.5 + draws["off_c"].float().view(-1, 1, 1)
    t = (draws["angle"] * (math.pi / 180.0)).view(-1, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = rows - cy, cols - cx
    rows, cols = torch.sin(t) * dx + torch.cos(t) * dy + cy, torch.cos(t) * dx - torch.sin(t) * dy + cx
    src = torch.cat([images.float(), F.one_hot(labels.long(), classes).float()], -1)
    out = _sample(src, rows, cols)
    gate = draws["gate"].view(-1, 1, 1)
    images = torch.where(gate[..., None], out[..., :c], images)
    labels = torch.where(gate, out[..., c:].argmax(-1).to(labels.dtype), labels)
    for key, dim in (("flip_lr", 2), ("flip_ud", 1)):
        coin = draws[key]
        images = torch.where(coin.view(-1, 1, 1, 1), images.flip(dim), images)
        labels = torch.where(coin.view(-1, 1, 1), labels.flip(dim), labels)
    return images, labels
