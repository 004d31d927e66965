"""What the runners share: the reference of a cell's configuration, the
upload, the reference's float32 precision switch, the profiled window, and
the device's busy time over a whole window."""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import trace


class Clock:
    """Seconds of each phase of a set-up, each ended at a synchronisation."""

    def __init__(self, device):
        self.device, self.laps, self.t = device, [], time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now


def family(c):
    """The cell's reference module, ``benchmark.reference.<family>``, named
    by its configuration's ``family``."""
    return importlib.import_module(f"benchmark.reference.{c.config['family']}")


def reference_model(c, overrides=None):
    return family(c).build(c.config["experiment"], overrides)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host batch on the device as the train loop moves it: through
    page-locked memory, asynchronously."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in float32 (TF32 off), or in TF32 for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profiled(device, body, host_ops: bool = True):
    """Runs ``body()`` under torch.profiler and returns (body's result, the
    reduced ``trace.Trace``). With ``host_ops`` the profiler records the
    host's ops and the ``bench.*`` spans beside the device's activity;
    without, the device's activity alone (and the launches), which slows
    the host's issue far less, in a window timed by the host's clock between
    two synchronisations. The chrome trace goes through a temporary file,
    deleted at once."""
    on_card = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CUDA] if on_card else []
    if host_ops or not on_card:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        sync(device)
        t0 = time.perf_counter()
        out = body()
        sync(device)
        took = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return out, trace.Trace.load(path, None if host_ops else took)
    finally:
        os.remove(path)


@contextlib.contextmanager
def device_busy(device, on: bool = True):
    """Seconds in which a kernel, copy or set ran on the device while the
    block ran, their intervals merged: a trace of the device's activity
    alone (as ``profiled(host_ops=False)``) over the whole block, its work
    waited for before the trace stops, and its events on the device read
    from the profiler's own records rather than through an exported file,
    since a window of a host-paced cell holds over a million of them
    (reading them takes about as long again as the block, after it). Yields
    a dict whose ``busy_s`` is set once the block has ended; it stays None
    where ``on`` is false or the device is no card."""
    got = {"busy_s": None}
    if not on or torch.device(device).type != "cuda":
        yield got
        return
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        yield got
        sync(device)
    finally:
        prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    got["busy_s"] = merged_s([(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                              if e.device_type() == cuda])


def merged_s(intervals) -> float:
    """Seconds covered by (start, end) intervals in nanoseconds, overlaps
    counted once."""
    busy, start, end = 0, None, None
    for ts, te in sorted(intervals):
        if end is None or ts > end:
            busy += 0 if end is None else end - start
            start, end = ts, te
        else:
            end = max(end, te)
    return (busy + (0 if end is None else end - start)) / 1e9
