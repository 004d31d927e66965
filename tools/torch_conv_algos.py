#!/usr/bin/env python3
"""cuDNN's convolution algorithms in one benchmark cell, read by the
program's convolution spans, on one CUDA card.

    python3 tools/torch_conv_algos.py --workload phiseg_lidc.train_bs12 [--seed 7] \\
        [--limit 2] [--device cpu]

Sets the cell up as ``benchmark/run.py`` does; with ``--limit`` the
``cudnn.benchmark_limit`` that ``Trainer`` sets (2) is replaced right after
it is built: the number of the heuristic's candidates cuDNN times a key (1:
the heuristic's own pick; 0: all). Every step (image) of the set-up is
timed on the wall clock between two synchronisations, so the first one
shows what the search costs. Then the cell's traced windows run
(``run.traced()``) and the tool prints, for each ``uz.conv.*`` span name:
calls a step (image), device ms a step of the kernels launched under it,
the FFT family's share of that (``spans.FFT_KERNELS``) and the family of
most of it; then the backward's (``bench.backward``) device ms by family
and its longest kernels. Each
line carries the card's name and power limit; the last line is a JSON
object of the readings. Exits 1 without a card; ``--device cpu`` runs the
cell cut to the benchmark tests' size (``benchmark/tiny.py``) instead, to
rehearse the tool.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.run import card_line, steady_host  # noqa: E402

# kernel families by name, the first match wins (the FFT patterns are the benchmark's own)
FAMILIES = (("FFT", None), ("Winograd", ("inograd",)), ("layout", ("nhwcToNchw", "nchwToNhwc")),
            ("implicit GEMM", ("implicit_gemm", "implicit_precomp", "xmma_fprop", "xmma_dgrad", "xmma_wgrad",
                               "_gemm_")),
            ("direct", ("dgrad_engine", "wgrad_alg", "dgrad2d", "wgrad2d", "conv2d_", "convolve")))


def family(name: str, fft) -> str:
    for label, patterns in FAMILIES:
        if any(p in name for p in (fft if patterns is None else patterns)):
            return label
    return "other"


def timed_calls(cls, method: str, record: list, device) -> None:
    """``cls.method`` replaced by itself timed on the wall clock between two
    synchronisations of ``device``, each call's seconds appended to
    ``record``."""
    from benchmark.harness import common

    inner = getattr(cls, method)

    def timed(self, *args, **kwargs):
        common.sync(device)
        t0 = time.perf_counter()
        out = inner(self, *args, **kwargs)
        common.sync(device)
        record.append(time.perf_counter() - t0)
        return out

    setattr(cls, method, timed)


def by_span(trace, named, fft) -> dict:
    """{span name: {kernel name: device seconds}} of the kernels launched
    under each of ``named`` {name: intervals}, which do not overlap."""
    flat = sorted((t0, t1, name) for name, ivs in named.items() for t0, t1 in ivs)
    starts = [iv[0] for iv in flat]
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    for ts, end, kernel, corr in trace.device:
        at = trace.launched_at.get(corr)
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= flat[i][1]:
            out[flat[i][2]][kernel] += (end - ts) / 1e6
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    steady_host()

    import torch

    torch.set_num_threads(1)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_conv_algos: no CUDA device", file=sys.stderr)
        return 1
    from benchmark import tiny
    from benchmark.harness import spans, spec
    from benchmark.harness.evaluate import EvalRun
    from benchmark.harness.train import TrainRun
    from unet_zoo_tpu_torch.training import Trainer

    card, dev = card_line(), torch.device(args.device, 0)
    c, overrides = (spec.cell(args.workload), None) if on_card else tiny.cell(args.workload)
    peak_bytes = torch.cuda.max_memory_allocated if on_card else lambda _: 0
    kind = c.workload["kind"]
    build = Trainer.__init__

    def limited(self, *a, **k):
        build(self, *a, **k)
        torch.backends.cudnn.benchmark_limit = args.limit

    if args.limit is not None:
        Trainer.__init__ = limited
    calls = []
    timed_calls(Trainer, "train_step" if kind == "train" else "eval_image", calls, dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as log_dir:
        run = {"train": TrainRun, "eval": EvalRun}[kind](c, args.seed, dev, log_dir, overrides)
        run.setup()
        setup_s = time.perf_counter() - t0
        setup_peak, calls = peak_bytes(dev), list(calls)
        ctx = run.traced()
        peak = peak_bytes(dev)
        run.free()
    tr, units, fft = ctx["trace"], ctx["units"], spans.FFT_KERNELS
    limit = torch.backends.cudnn.benchmark_limit
    label = f"{args.workload} seed {args.seed}, limit {limit}"
    print(f"[setup] {label}: {', '.join(f'{k} {v:.3f} s' for k, v in run.phases)}; {setup_s:.3f} s in all; "
          f"each {'step' if kind == 'train' else 'image'} of the set-up {' '.join(f'{s:.3f}' for s in calls)} s; "
          f"peak {setup_peak} B in set-up, {peak} B with the traced windows | card: {card}")

    named = {n: ivs for n, ivs in (spans.program_spans(tr) or {}).items() if n.startswith("conv.")}
    rows = []
    for name, kernels in by_span(tr, named, fft).items():
        fams = collections.defaultdict(float)
        for k, s in kernels.items():
            fams[family(k, fft)] += s
        total = sum(kernels.values())
        top = max(kernels, key=kernels.get)
        rows.append({"span": name, "calls": len(named[name]) / units, "ms": total / units * 1e3,
                     "fft_ms": fams["FFT"] / units * 1e3, "family": max(fams, key=fams.get),
                     "families_ms": {f: s / units * 1e3 for f, s in fams.items()}, "top_kernel": top[:120]})
    rows.sort(key=lambda r: -r["ms"])
    print(f"[conv] {label}: {len(rows)} shapes, device ms a {'step' if kind == 'train' else 'image'} "
          f"{sum(r['ms'] for r in rows):.2f}, FFT {sum(r['fft_ms'] for r in rows):.2f} | card: {card}")
    for r in rows:
        print(f"[conv]   {r['span']:<28} calls {r['calls']:5.1f}  {r['ms']:9.3f} ms  FFT {r['fft_ms']:9.3f}  "
              f"{r['family']:<14} {r['top_kernel'][:90]}")
    backward = {}
    if "backward" in tr.spans:
        kernels = by_span(tr, {"backward": tr.spans["backward"]}, fft)["backward"]
        fams = collections.defaultdict(float)
        for k, s in kernels.items():
            fams[family(k, fft)] += s
        backward = {"ms": sum(kernels.values()) / units * 1e3,
                    "families_ms": {f: s / units * 1e3 for f, s in sorted(fams.items(), key=lambda kv: -kv[1])},
                    "top": [(k[:120], s / units * 1e3) for k, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]]}
        print(f"[backward] {label}: {backward['ms']:.2f} ms a step; by family "
              + ", ".join(f"{f} {ms:.2f}" for f, ms in backward["families_ms"].items()) + f" | card: {card}")
        for k, ms in backward["top"]:
            print(f"[backward]   {ms:8.3f} ms  {k[:110]}")
    launches = ctx["light"].launches() / units
    print(json.dumps({"workload": args.workload, "seed": args.seed, "limit": limit,
                      "card": card, "setup_s": setup_s, "phases": run.phases, "setup_calls_s": calls,
                      "setup_peak_bytes": setup_peak, "peak_bytes": peak, "launches": launches,
                      "busy_s": ctx["light"].busy_s, "window_s": ctx["light"].window_s, "units": units,
                      "convolutions": rows, "backward": backward}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
