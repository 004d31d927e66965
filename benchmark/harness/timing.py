"""Peaks and the roofline's arithmetic, frozen here so that no later
change to the program moves the yardstick. Each names what of
``chip_smoke.py`` (the port's bring-up checks, repository root) it was
copied from. ``chip_smoke.py``'s held-stream ``host_ms`` and ``device_ms``
are not copied: the launch queue holds ~1024 launches, and a PHiSeg step or
an evaluated image issues several times that, so with the stream held the
host waits on the queue and the events read it. The host's share is
counted as launches from the trace instead.
"""

from __future__ import annotations

# copied from chip_smoke.py PEAK_*: the card's published peaks (NVIDIA H100
# SXM data sheet, dense, at 700 W); TF32 on the tensor cores, of which
# 3xTF32 (three products a multiply-add, float32-accurate) has a third
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_S = 3.35e12


def chain_cost(batch, size, chans, itemsize: int = 2):
    """Copied from chip_smoke.py ``chain_cost``. (FLOPs, bytes) of a chain:
    2*9*C_in*C_out a pixel and stage; the chain's input and output read and
    written once, and its weights, all of ``itemsize`` bytes."""
    pixels = batch * size * size
    flops = sum(2 * 9 * ci * co * pixels for ci, co in chans)
    nbytes = itemsize * (pixels * (chans[0][0] + chans[-1][1]) + sum(9 * ci * co for ci, co in chans))
    return flops, nbytes


def bound(flops, nbytes, peak_flops: float = PEAK_BF16_FLOPS):
    """Copied from chip_smoke.py ``bound``. The least time in ms the card
    could take at ``peak_flops``: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_for(dtype: str) -> float:
    """The peak a configuration's share is taken of: float32 products at
    float32 accuracy on the tensor cores (3xTF32), or bf16's."""
    return {"float32": PEAK_3XTF32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}[dtype]
