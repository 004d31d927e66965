"""What the runners share: the reference of a cell's configuration, the
upload, the reference's float32 precision switch, and the profiled window."""

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


def reference_model(c, overrides=None):
    family = importlib.import_module(f"benchmark.reference.{c.config['family']}")
    return family.build(c.config["experiment"], overrides)


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
