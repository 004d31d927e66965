"""Profiling helpers, the twin of ``unet_zoo_tpu.utils.profiling``.

``trace`` records the enclosed block with ``torch.profiler`` (CPU and,
where a card is present, CUDA activities) and writes a JSON trace that
TensorBoard's profile plugin and Perfetto read. ``span`` marks a phase of
the program in such a trace, ``uz.<name>``, where the work happens; while
no profile is active it costs one flag check. ``device_memory_stats``
gives ``torch.cuda.memory_stats`` under the key names the JAX function
returns. ``step_memory_analysis`` has no compiled counterpart here: it
runs the function once and measures its peak, as ``tools/torch_memory.py``
does.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger(__name__)

# the program's span prefix in a trace, beside the benchmark's "bench."
SPAN_PREFIX = "uz."
# spans kept by ``recorded_spans``, the newest last
RECORDED_SPANS = 1 << 20
_NULL = contextlib.nullcontext()
_recorded: "collections.deque[Tuple[str, int, int]]" = collections.deque(maxlen=RECORDED_SPANS)


class _Span:
    """``torch.profiler.record_function(name)``, and the interval of the work
    inside it on the host's wall clock, appended to the record
    ``recorded_spans`` reads."""

    __slots__ = ("name", "function", "start")

    def __init__(self, name: str):
        self.name = name
        self.function = torch.profiler.record_function(name)

    def __enter__(self) -> "_Span":
        self.function.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.function.__exit__(*exc)
        _recorded.append((self.name, self.start, end))


def span(name, *args):
    """A context that marks the enclosed work as the span ``uz.<name>`` while
    a ``torch.profiler`` profile is active; otherwise one shared null
    context. ``name`` is a string, or a function that ``args`` are given to
    and that returns it (a name that carries a shape), called only while a
    profile is active. The span is a ``record_function`` on kineto's clock,
    the clock of the trace's kernels, so a trace viewer shows each kernel,
    and each idle gap of the device, under the spans open on the host when
    it was launched."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(SPAN_PREFIX + (name(*args) if args else name))


def recorded_spans() -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) on the host's wall clock (``time.time_ns``)
    of the last ``RECORDED_SPANS`` spans that closed while a profile was
    active, in the order they closed: what a reader in the same process
    holds against the profile's trace, whose clock is the wall clock less a
    constant."""
    return list(_recorded)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Trace the enclosed block into ``log_dir/name`` and yield that path:

        with trace("logs/profile"):
            trainer.train(data, iterations=trainer.state.step + 10)

    The chrome trace holds the program's ``uz.*`` spans (``span``) on the
    same clock as the kernels (kineto's), so Perfetto shows which span each
    kernel, and each gap in which the device idles, falls under."""
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
