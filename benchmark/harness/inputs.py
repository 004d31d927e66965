"""Everything a run feeds the program, drawn from ``--seed`` on the card in
a few large calls: the data (synthetic LIDC at its shapes), the weights,
and each step's or image's draws, which the program and the reference both
receive.

Every draw comes from a device generator seeded by ``mix(seed, ...)``, so a
seed gives the same inputs in every run, and a seed's work has the same
sizes as any other's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# salts of the streams drawn from one seed
DATA, WEIGHTS, STEP, IMAGE, PICKS = 1, 2, 3, 4, 5


def mix(seed: int, *salt: int) -> int:
    """A 64-bit generator seed from the run's seed and a stream's salt."""
    return int(np.random.SeedSequence([seed % 2 ** 64, *salt]).generate_state(1, np.uint64)[0])


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *salt))


def lidc_split(n: int, size: int, graders: int, seed: int, split: int, device,
               chunk: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` LIDC-shaped cases: images (n, size, size) float64 with the
    cache's -0.5 offset, a smooth lesion blob in noise; labels (n, size,
    size, graders) uint8, each grader a jittered disc of the lesion, 15% of
    graders seeing none (the graders' disagreement)."""
    g = generator(device, seed, DATA, split)
    images = np.empty((n, size, size), np.float64)
    labels = np.empty((n, size, size, graders), np.uint8)
    grid = torch.arange(size, dtype=torch.float32, device=device)
    for s0 in range(0, n, chunk):
        m = min(chunk, n - s0)
        u = torch.rand((m, 3 + 2 * graders), generator=g, device=device)
        cy, cx = (0.3 + 0.4 * u[:, 0:2] * 1.0).mul(size).unbind(1)
        r = (0.08 + 0.12 * u[:, 2]) * size
        dist = torch.sqrt((grid.view(1, -1, 1) - cy.view(-1, 1, 1)) ** 2 + (grid.view(1, 1, -1) - cx.view(-1, 1, 1)) ** 2)
        noise = torch.randn((m, size, size), generator=g, device=device)
        img = torch.exp(-(dist / (1.5 * r.view(-1, 1, 1))) ** 2) + 0.05 * noise - 0.5
        jitter = 0.85 + 0.3 * u[:, 3:3 + graders]
        seen = u[:, 3 + graders:] >= 0.15
        masks = (dist[..., None] < (r[:, None] * jitter).view(m, 1, 1, graders)) & seen.view(m, 1, 1, graders)
        images[s0:s0 + m] = img.double().cpu().numpy()
        labels[s0:s0 + m] = masks.to(torch.uint8).cpu().numpy()
    return images, labels


def lidc_arrays(counts: Dict[str, int], size: int, graders: int, seed: int, device) -> dict:
    """The cache's schema for ``LIDCData``: splits train, val and test, each
    with ``images`` and ``labels`` (a split the cell does not use is empty)."""
    out = {}
    for k, split in enumerate(("train", "val", "test")):
        n = counts.get(split, 0)
        images, labels = lidc_split(n, size, graders, seed, k, device)
        out[split] = {"images": images, "labels": labels, "uids": np.arange(n, dtype=np.int64)}
    return out


def weights(specs: Sequence[tuple], seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, buffers) from ``specs`` (path, shape, init): one uniform
    and one normal draw for all of them, cut into the leaves. BatchNorm's
    running statistics are the buffers."""
    g = generator(device, seed, WEIGHTS)
    uniform = [s for s in specs if s[2][0] == "uniform"]
    normal = [s for s in specs if s[2][0] in ("he_normal", "trunc_normal")]
    u = torch.rand(sum(math.prod(s[1]) for s in uniform), generator=g, device=device)
    z = torch.randn(sum(math.prod(s[1]) for s in normal), generator=g, device=device)
    drawn = {}
    for group, flat in ((uniform, u), (normal, z)):
        at = 0
        for name, shape, (kind, scale) in group:
            t = flat[at:at + math.prod(shape)].view(shape)
            at += t.numel()
            # a truncated normal cut at 2 std by clamping: the scale, not the tails, matters here
            drawn[name] = {"uniform": (2 * t - 1) * scale, "he_normal": t * scale,
                           "trunc_normal": t.clamp(-2, 2) * scale}[kind]
    params, buffers = {}, {}
    for name, shape, (kind, value) in specs:
        t = drawn[name] if name in drawn else torch.full(shape, float(value), device=device)
        (buffers if name.endswith(("running_mean", "running_var")) else params)[name] = t.contiguous()
    return params, buffers


def load_into(model: torch.nn.Module, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor]) -> None:
    """Copies the drawn leaves into the port's model by path; raises where
    the two do not name the same leaves of the same shapes."""
    have = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    want = {**params, **buffers}
    if set(have) != set(want):
        raise ValueError(f"the port's model and the reference differ in leaves: only in the port "
                         f"{sorted(set(have) - set(want))[:5]}, only in the reference {sorted(set(want) - set(have))[:5]}")
    with torch.no_grad():
        for name, t in want.items():
            if have[name].shape != t.shape:
                raise ValueError(f"{name}: the port's shape {tuple(have[name].shape)}, the reference's {tuple(t.shape)}")
            have[name].copy_(t)


def step_draws(seed: int, step: int, batch: int, size: Tuple[int, int], aug: dict, noise, device) -> dict:
    """One train step's draws, with the published ranges: per image a gate
    (1 in ``augment_every_nth``), an angle U(-rot, rot) degrees, a crop side r
    in [H - offset, H] and its corner, each flip with probability 1/2; and
    where ``noise`` (the reference model's ``noise_shapes(batch)``) names
    any, the posterior's z noise at those shapes, as the program takes it."""
    g = generator(device, seed, STEP, step)
    nh, nw = size
    u = torch.rand((7, batch), generator=g, device=device)
    off = aug["offset"]
    r = (nh - off + (u[2] * (off + 1)).long().clamp(max=off))
    draws = {
        "gate": u[0] < 1.0 / aug["augment_every_nth"],
        "angle": (2 * u[1] - 1) * aug["rot_degrees"],
        "r": r,
        "off_r": (u[3] * (nh - r + 1).float()).long().clamp(max=nh - r),
        "off_c": (u[4] * (nw - r + 1).float()).long().clamp(max=nw - r),
        "flip_lr": u[5] < 0.5,
        "flip_ud": u[6] < 0.5,
    }
    if noise:
        draws["z_eps"] = _normal_levels(g, noise, device)
    return draws


def image_draws(seed: int, index: int, noise: tuple, device) -> dict:
    """One evaluated image's noise at ``noise``, the reference model's
    ``image_noise_shapes``: ``eps`` for the samples and ``loss_eps`` for
    the eval-mode loss, as the program's ``eval_image`` takes them."""
    eps, loss_eps = _normal_levels(generator(device, seed, IMAGE, index), noise, device)
    return {"eps": eps, "loss_eps": loss_eps}


def _is_shape(s) -> bool:
    return isinstance(s, tuple) and len(s) > 0 and all(isinstance(n, int) for n in s)


def _shapes(s) -> List[tuple]:
    return [s] if _is_shape(s) else [leaf for e in s for leaf in _shapes(e)]


def _normal_levels(g: torch.Generator, shapes, device):
    """Standard normal tensors at ``shapes``: a shape (a tuple of ints), or
    a list or tuple of them, nested; one draw for all, cut in order, depth
    first, and returned nested alike."""
    sizes = [math.prod(s) for s in _shapes(shapes)]
    flat = iter(torch.randn(sum(sizes), generator=g, device=device).split(sizes))

    def nest(s):
        return next(flat).view(s) if _is_shape(s) else type(s)(nest(e) for e in s)

    return nest(shapes)
