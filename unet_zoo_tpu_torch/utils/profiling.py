"""Profiling helpers, the twin of ``unet_zoo_tpu.utils.profiling``.

``trace`` records the enclosed block with ``torch.profiler`` (CPU and,
where a card is present, CUDA activities) and writes a JSON trace that
TensorBoard's profile plugin and Perfetto read. ``device_memory_stats``
gives ``torch.cuda.memory_stats`` under the key names the JAX function
returns. ``step_memory_analysis`` has no compiled counterpart here: it
runs the function once and measures its peak, as ``tools/torch_memory.py``
does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Trace the enclosed block into ``log_dir/name`` and yield that path:

        with trace("logs/profile"):
            trainer.train_step(x, y)
    """
    path = os.path.join(log_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time()
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(path)):
        yield path
    log.info("trace (%.2fs) written to %s", time.time() - t0, path)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's memory statistics (``torch.cuda.memory_stats``), with the
    PJRT names the JAX function returns for the current and peak bytes
    (``bytes_in_use``, ``peak_bytes_in_use``) beside PyTorch's own keys;
    None on the CPU."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_reserved"] = stats.get("reserved_bytes.all.current", 0)
    return stats


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return 0


def step_memory_analysis(fn, *args) -> Dict[str, int]:
    """The memory of one call ``fn(*args)`` on the card, measured (not
    compiled, as XLA's memory analysis is in the JAX package): the tensor
    arguments' bytes (``argument_bytes``), the peak allocated while the
    call runs above what was allocated before it, plus the arguments
    (``peak_bytes``), the result's tensors (``output_bytes``) and the
    peak less the arguments (``temp_bytes``). Needs a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("step_memory_analysis measures the card's allocator: no CUDA device")
    argument_bytes = _bytes(list(args))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + argument_bytes
    return {"argument_bytes": argument_bytes, "output_bytes": _bytes(out), "temp_bytes": peak - argument_bytes,
            "peak_bytes": peak}
