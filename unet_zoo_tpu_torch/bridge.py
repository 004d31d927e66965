"""Carry the JAX package's parameters into the port's ``state_dict``.

Input: the nested dict of numpy arrays that ``jax.device_get(variables["params"])``
returns for a model of ``unet_zoo_tpu``. A leaf at ``a/b/.../kernel`` becomes
``a.b....weight`` and ``a/b/.../bias`` becomes ``a.b....bias``. Conv kernels
go from flax's HWIO to the port's OIHW (``nn.Conv2d`` layout) by
``transpose(3, 2, 0, 1)``. Values stay float32 on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def _torch_name(path: str) -> str:
    *scope, leaf = path.split("/")
    if leaf not in ("kernel", "bias"):
        raise KeyError(f"unexpected parameter '{path}' (only conv kernel/bias are ported)")
    return ".".join(scope + ["weight" if leaf == "kernel" else "bias"])


def state_dict_from_jax(params: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Map JAX ``params`` onto ``model``'s state_dict keys and shapes.

    Raises ``KeyError`` on a key missing from either side and ``ValueError``
    on a shape that does not match.
    """
    expected = model.state_dict()
    out = {}
    for path, value in _flatten(params).items():
        name = _torch_name(path)
        if value.ndim == 4:  # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        out[name] = torch.tensor(value, dtype=torch.float32)
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


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX ``params`` into ``model`` in place and return it."""
    model.load_state_dict(state_dict_from_jax(params, model))
    return model
