"""Carry the JAX package's variables into the port's ``state_dict``.

Input: the nested dicts of numpy arrays that ``jax.device_get(variables["params"])``
and, for a model with BatchNorm, ``jax.device_get(variables["batch_stats"])``
return for a model of ``unet_zoo_tpu``. A leaf at ``a/b/.../kernel`` becomes
``a.b....weight``, ``.../bias`` becomes ``....bias`` and a BatchNorm's
``.../scale`` becomes ``....weight``; in ``batch_stats``, ``.../mean`` and
``.../var`` become ``....running_mean`` and ``....running_var``. ProbUNet's
Gaussian heads keep their names (``.../head_kernel``, ``.../head_bias``). A
reversible sequence's flat leaves keep their names: ``.../rev/block0_f_kernel``,
``_bias``, ``_scale`` and ``_shift`` become ``....rev.block0_f_kernel`` and so
on, and its ``block0_f_mean``/``_var`` statistics the buffers of those names.
Conv kernels go from flax's HWIO to the port's OIHW (``nn.Conv2d`` layout)
by ``transpose(3, 2, 0, 1)``, and PHiSeg3D's DHWIO to OIDHW (``nn.Conv3d``)
by ``transpose(4, 3, 0, 1, 2)``. Values stay float32 on the CPU.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "head_kernel": "head_kernel",
                 "head_bias": "head_bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
# a reversible sequence's leaves, which keep their names
_REV_PARAM = re.compile(r"block\d+_[fg]_(kernel|bias|scale|shift)")
_REV_STAT = re.compile(r"block\d+_[fg]_(mean|var)")


def _torch_name(path: str, leaves: Mapping[str, str]) -> str:
    *scope, leaf = path.split("/")
    if (_REV_STAT if leaves is _STAT_LEAVES else _REV_PARAM).fullmatch(leaf):
        return ".".join(scope + [leaf])
    if leaf not in leaves:
        raise KeyError(f"unexpected leaf '{path}' (expected one of {sorted(leaves)} or a reversible block's)")
    return ".".join(scope + [leaves[leaf]])


def state_dict_from_jax(params: Mapping[str, Any], model: torch.nn.Module,
                        batch_stats: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Map JAX ``params`` (and ``batch_stats``) onto ``model``'s state_dict
    keys and shapes.

    Raises ``KeyError`` on a key missing from either side and ``ValueError``
    on a shape that does not match.
    """
    expected = model.state_dict()
    out = {}
    for tree, leaves in ((params, _PARAM_LEAVES), (batch_stats or {}, _STAT_LEAVES)):
        for path, value in _flatten(tree).items():
            if value.ndim == 4:  # HWIO -> OIHW
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 5:  # DHWIO -> OIDHW
                value = value.transpose(4, 3, 0, 1, 2)
            out[_torch_name(path, leaves)] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing {missing}, extra {extra}")
    for name, value in out.items():
        if value.shape != expected[name].shape:
            raise ValueError(
                f"{name}: JAX gives {tuple(value.shape)}, the model has {tuple(expected[name].shape)}"
            )
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None) -> torch.nn.Module:
    """Load JAX ``params`` (and ``batch_stats``, which a model with BatchNorm
    needs) into ``model`` in place and return it."""
    model.load_state_dict(state_dict_from_jax(params, model, batch_stats))
    return model
