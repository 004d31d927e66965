"""The program's own spans (``uz.*``, ``unet_zoo_tpu_torch.utils.profiling``)
held against a reduced trace (``trace.Trace``) of the same process: device
time launched while spans of a name or prefix were open on the host, and the
device's idle time while they were.

The program records each span that closes under a profile twice: as a
``record_function`` in the profile, and with its interval on the host's wall
clock (``profiling.recorded_spans``). ``Trace`` keeps the harness's
``bench.*`` spans and drops the program's, so the program's come from that
record, moved onto the trace's clock, which is the wall clock less a constant:
the constant lies between the bounds that the program's spans opened and
closed inside the harness's own give (``NESTED``), and the middle is taken.
Where the program records no spans (a version without them), ``program_spans``
returns None and so does every reader built on it.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Intervals = List[Tuple[float, float]]

PREFIX = "uz."
# the harness's span around a public phase -> the program's spans that open and close inside it
NESTED = {"next_batch": ("data.next_batch",), "augment": ("step.augment",), "forward_loss": ("step.forward_loss",),
          "backward": ("step.backward",), "update": ("step.update",), "image": ("eval.upload", "eval.image", "eval.fetch")}
# cuDNN's FFT convolutions, by the names of their kernels: the transforms (cuFFT's and cuDNN's own), the
# complex GEMM, the pointwise complex product, and the tiling of the complex tiles between them
# (``region_transform_ABC_val<..., TransformParamsABC<float2, ...>>``, under FFT convolutions alone in the traced
# cells; cuDNN's layout transposes ``nhwcToNchwKernel``/``nchwToNhwcKernel`` serve every algorithm and stay out)
FFT_KERNELS = ("fft", "DSE::", "cf32cf32", "pointwise_mult_and_sum_complex", "region_transform")


def _program_record() -> Optional[List[Tuple[str, int, int]]]:
    try:
        from unet_zoo_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def program_spans(trace, record: Optional[Sequence[Tuple[str, int, int]]] = None) -> Optional[Dict[str, Intervals]]:
    """{name without ``uz.``: sorted intervals on the trace's clock (us)} of
    the program's spans inside the trace's window, from ``record`` (by
    default the program's, ``profiling.recorded_spans``). The last spans of
    each name in ``NESTED`` are paired, in order, with the harness's spans
    they opened inside. None where no pair is found."""
    record = _program_record() if record is None else record
    if not record:
        return None
    ref = record[0][1]  # ns; the record's times are taken relative to it, in us, to keep a double's precision
    mine: Dict[str, Intervals] = collections.defaultdict(list)
    for name, t0, t1 in record:
        if name.startswith(PREFIX):
            mine[name[len(PREFIX):]].append(((t0 - ref) / 1e3, (t1 - ref) / 1e3))
    lo, hi = -float("inf"), float("inf")  # bounds of (record's time - trace's time)
    for outer, inners in NESTED.items():
        theirs = trace.spans.get(outer, [])
        for inner in inners:
            ours = sorted(mine.get(inner, []))[-len(theirs):] if theirs else []
            if len(ours) != len(theirs):
                continue
            for (b0, b1), (u0, u1) in zip(theirs, ours):
                hi, lo = min(hi, u0 - b0), max(lo, u1 - b1)
    if hi == float("inf"):
        return None
    shift = (lo + hi) / 2
    out = {}
    for name, intervals in mine.items():
        kept = sorted((t0 - shift, t1 - shift) for t0, t1 in intervals)
        kept = [(t0, t1) for t0, t1 in kept if t0 >= trace.start and t1 <= trace.end]
        if kept:
            out[name] = kept
    return out


def union(spans: Dict[str, Intervals], prefix: str) -> Intervals:
    """The union of the intervals of every span whose name starts with
    ``prefix`` (the whole name for one span), merged and sorted."""
    merged: Intervals = []
    for t0, t1 in sorted(iv for name, ivs in spans.items() if name.startswith(prefix) for iv in ivs):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def _covers(intervals: Intervals, t: float) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t <= intervals[i][1]


def device_s(trace, intervals: Intervals, kernels: Optional[Iterable[str]] = None) -> float:
    """Seconds of the device's kernels, copies and sets launched (on any
    thread) at a time ``intervals`` cover, each counted once; with
    ``kernels``, only those whose name holds one of the patterns."""
    kernels = tuple(kernels) if kernels is not None else None
    total = 0.0
    for ts, end, name, corr in trace.device:
        at = trace.launched_at.get(corr)
        if at is None or not _covers(intervals, at):
            continue
        if kernels is None or any(k in name for k in kernels):
            total += end - ts
    return total / 1e6


def idle_s(trace, intervals: Intervals) -> float:
    """Seconds of the trace's window in which the device ran nothing while
    ``intervals`` were open on the host."""
    busy: Intervals = []
    for ts, end, _, _ in trace.device:
        ts, end = max(ts, trace.start), min(end, trace.end)
        if end <= ts:
            continue
        if busy and ts <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], end))
        else:
            busy.append((ts, end))
    total, j = 0.0, 0
    for t0, t1 in intervals:
        t0, t1 = max(t0, trace.start), min(t1, trace.end)
        if t1 <= t0:
            continue
        open_s = t1 - t0
        while j < len(busy) and busy[j][1] <= t0:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < t1:
            open_s -= min(busy[k][1], t1) - max(busy[k][0], t0)
            k += 1
        total += open_s
    return total / 1e6


def reading(ctx, kind: str, prefix: str, kernels: Optional[Iterable[str]] = None, idle: bool = False
            ) -> Optional[float]:
    """A reader's value for cells of ``kind``: ms a step or image of the
    device work launched under the program's spans named by ``prefix`` (with
    ``kernels``, those kernels alone), or with ``idle`` the device's idle
    time while they were open; None where the program records no spans."""
    if ctx["kind"] != kind:
        return None
    spans = program_spans(ctx["trace"])
    if spans is None:
        return None
    intervals = union(spans, prefix)
    seconds = idle_s(ctx["trace"], intervals) if idle else device_s(ctx["trace"], intervals, kernels)
    return seconds / ctx["units"] * 1e3
