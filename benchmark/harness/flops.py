"""Operations a step or an evaluated image needs, counted once from the
reference at the cell's shapes (``torch.utils.flop_counter`` over the
reference's forward and backward on the meta device: no data, nothing
recomputed, nothing of the program), and the least time of the U-Net's
conv chains by ``timing.chain_cost`` and ``timing.bound``."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import timing
from benchmark.reference import metrics as ref_metrics

META = torch.device("meta")


def _leaves(model, grad: bool):
    params, bufs = {}, {}
    for name, shape, _ in model.specs():
        t = torch.zeros(shape, device=META)
        if name.endswith(("running_mean", "running_var")):
            bufs[name] = t
        else:
            params[name] = t.requires_grad_(grad)
    return params, bufs


def train_step(model, batch: int) -> int:
    """FLOPs of one train step's forward and backward at ``batch``."""
    params, bufs = _leaves(model, True)
    h, w = model.image_size
    x = torch.zeros((batch, model.in_channels, h, w), device=META)
    mask = torch.zeros((batch, h, w), dtype=torch.long, device=META)
    with FlopCounterMode(display=False) as counter:
        loss = model.step_loss(params, bufs, x, mask)["loss"]
        loss.backward()
    return counter.get_total_flops()


def eval_image(model, samples: int, n_loss: int, graders: int) -> int:
    """FLOPs of one image's evaluation: ``samples`` prior samples decoded,
    the metrics' products, the eval-mode loss on ``n_loss`` repeats."""
    params, bufs = _leaves(model, False)
    h, w = model.image_size
    x = torch.zeros((1, model.in_channels, h, w), device=META)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.sample(params, bufs, x, samples)
        masks = torch.zeros((samples + graders, h * w), dtype=torch.long, device=META)
        ref_metrics._distances(masks, model.C)
        mask = torch.zeros((n_loss, h, w), dtype=torch.long, device=META)
        model.step_loss(params, bufs, x.expand(n_loss, -1, -1, -1), mask, train=False)
    return counter.get_total_flops()


def chain_stages(model, batch: int):
    """(batch, size, C_in, C_out) of each stage of the U-Net's 3-conv blocks."""
    sizes = model.block_sizes()
    return [(batch, sizes[name][0], ci if i == 0 else co, co)
            for name, ci, co in model.blocks() for i in range(3)]


def chain_least_s(model, batch: int, itemsize: int = 4, peak: float = timing.PEAK_3XTF32_FLOPS) -> float:
    """Least time of a step's chain stages: the sum over stages of
    max(FLOPs / peak, bytes / bandwidth), each stage's input, output and
    weights moved once."""
    return sum(timing.bound(*timing.chain_cost(b, s, [(ci, co)], itemsize), peak)[0]
               for b, s, ci, co in chain_stages(model, batch)) / 1e3
