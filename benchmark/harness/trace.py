"""The reduction of a torch.profiler chrome trace (host ops, the harness's
``bench.*`` spans, runtime launches and the device's kernels, copies and
sets, all on one clock in microseconds) to what the per-layer metrics read:
the traced window, the device's busy time in it, device time by the span
whose host interval launched it, kernel time by name, the launches, and the
idle gaps named by what the host was doing.

A trace of the device alone (no host ops, no spans) has its window given
by the host's clock around it: that is the window whose busy and idle time
the run reports, since recording every host op slows the host's issue."""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Tuple

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."
NAME_CHARS = 160  # a kernel's name in the breakdown is cut to this


class Trace:
    def __init__(self, events: List[dict], window_s: float = None):
        self.spans: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        self.device: List[Tuple[float, float, str, object]] = []
        self.launched_at: Dict[object, float] = {}
        ops: Dict[int, List[Tuple[float, float, str]]] = collections.defaultdict(list)
        span_tid = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, end = e.get("cat"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
                self.spans[e["name"][len(SPAN_PREFIX):]].append((ts, end))
                span_tid = e["tid"]
            elif cat in DEVICE:
                self.device.append((ts, end, e["name"], e.get("args", {}).get("correlation")))
            elif cat in LAUNCH and "correlation" in e.get("args", {}):
                self.launched_at[e["args"]["correlation"]] = ts
            elif cat == "cpu_op":
                ops[e["tid"]].append((ts, end, e["name"]))
        for v in self.spans.values():
            v.sort()
        self.device.sort()
        spans = [s for v in self.spans.values() for s in v]
        if window_s is not None:  # the device alone, between two synchronisations
            self.start = min(self.launched_at.values(), default=self.device[0][0] if self.device else 0.0)
            self.end = self.start + window_s * 1e6
        elif not spans:
            raise ValueError("the trace holds no bench.* span")
        else:
            self.start = min(s[0] for s in spans)
            self.end = max([s[1] for s in spans] + [d[1] for d in self.device])
        self.host_ops = _outermost(sorted(ops.get(span_tid, [])))

    @classmethod
    def load(cls, path: str, window_s: float = None) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], window_s)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def _busy(self) -> List[Tuple[float, float]]:
        merged = []
        for ts, end, _, _ in self.device:
            ts, end = max(ts, self.start), min(end, self.end)
            if end <= ts:
                continue
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(end - ts for ts, end in self._busy()) / 1e6

    def device_s(self, span: str) -> float:
        """Seconds of device work launched while a span named ``span`` was open on the host."""
        intervals = self.spans.get(span, [])
        starts = [s for s, _ in intervals]
        total = 0.0
        for ts, end, _, corr in self.device:
            at = self.launched_at.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= intervals[i][1]:
                total += end - ts
        return total / 1e6

    def launches(self) -> int:
        """Runtime or driver calls of the window that put work on the
        device: one a kernel, copy or set, one a graph however many kernels
        it holds (they share its correlation)."""
        return len({corr for _, _, _, corr in self.device if corr in self.launched_at})

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``pattern``."""
        hits = [end - ts for ts, end, name, _ in self.device if pattern in name]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        by_name = collections.Counter()
        for ts, end, name, _ in self.device:
            by_name[name[:NAME_CHARS]] += (end - ts) / 1e6
        return [[k, v] for k, v in by_name.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds of the window summed by what the host was doing at
        each gap's middle: the innermost span and the outermost host op."""
        busy = self._busy()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        by_name = collections.Counter()
        op_starts = [o[0] for o in self.host_ops]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(op_starts, mid) - 1
            op = self.host_ops[i][2] if i >= 0 and mid <= self.host_ops[i][1] else "python"
            by_name[f"{self._span_at(mid)}:{op}"] += (g1 - g0) / 1e6
        return [[k, v] for k, v in by_name.most_common(n)]

    def _span_at(self, t: float) -> str:
        best, length = "outside", float("inf")
        for name, intervals in self.spans.items():
            i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
            if i >= 0 and t <= intervals[i][1] and intervals[i][1] - intervals[i][0] < length:
                best, length = name, intervals[i][1] - intervals[i][0]
        return best


def _outermost(ops: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The ops of one thread that no other op contains, in order."""
    out = []
    for op in ops:
        if not out or op[0] >= out[-1][1]:
            out.append(op)
    return out
