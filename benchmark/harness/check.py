"""The comparison that decides ``correct``: numbers read from the program's
outputs against the reference's, each held to its limit (the cell's
``limits`` in its workload file)."""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch


def rel(a: float, b: float, floor: float = 1e-12) -> float:
    """|a - b| / max(|b|, floor); infinite where either is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor)


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def worst_leaf(got: Dict[str, float], want: Dict[str, float], keep: Optional[Iterable[str]] = None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = list(want if keep is None else keep)
    median = statistics.median(want[k] for k in keys)
    worst = 0.0
    for k in keys:
        g = got.get(k, 0.0)
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - want[k]) / max(want[k], median, 1e-30))
    return worst


def moved_leaves(grads: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grads.values())
    return [k for k, v in grads.items() if v >= 1e-3 * median]


def held(value: float, limit: Optional[float]) -> bool:
    """A number without a limit is reported, not held."""
    return limit is None or (math.isfinite(value) and value <= limit)


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit."""
    return all(held(v, limits.get(k)) for k, v in readings.items())


def report(checks: Dict[str, dict]) -> None:
    """Each number compared beside its limit, on stderr."""
    for name, c in checks.items():
        ok = held(float(c["value"]), c["limit"])
        print(f"check {name} {c['value']!r} limit {c['limit']!r}{'' if ok else ' FAILED'}", file=sys.stderr)


def as_checks(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The result line's ``checks``: each number with its limit."""
    return {k: {"value": _json_number(v), "limit": limits.get(k)} for k, v in readings.items()}


def _json_number(v: float):
    return v if math.isfinite(v) else str(v)


def identify_rows(x: np.ndarray, y: np.ndarray, images: np.ndarray, labels: np.ndarray, index: dict):
    """For each fed row (x (B, H, W[, 1]) float32, y (B, H, W) int), the
    split's image it is and the grader whose mask it carries: (image,
    grader) or None where the row is no image of the split with one of its
    graders' masks."""
    out = []
    for xr, yr in zip(x.reshape(x.shape[0], *images.shape[1:]), y):
        i = index.get(xr[xr.shape[0] // 2].tobytes())
        if i is None or not np.array_equal(xr, images[i].astype(np.float32)):
            out.append(None)
            continue
        graders = [a for a in range(labels.shape[-1]) if np.array_equal(yr, labels[i, ..., a])]
        out.append((i, graders[0]) if graders else None)
    return out


def row_index(images: np.ndarray) -> dict:
    """The split's images keyed by their middle row as float32 bytes."""
    mid = images.shape[1] // 2
    return {images[i, mid].astype(np.float32).tobytes(): i for i in range(images.shape[0])}
