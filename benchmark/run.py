"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` reads its per-layer metrics from a profiled
window, then, where a reader asks for it (``WINDOW``), from a timed window
of ``--seconds``. Both check, once the window has closed, that what the timed path
produced agrees with the plain reference (``correct``), and print each
number compared beside its limit. Needs a CUDA card: without one (or with
fewer than the cell asks for) it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the JAX side of the repository, which nothing here may load (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "unet_zoo_tpu")
# the host cores a run keeps to: the issuing thread and autograd's device thread each have one
HOST_CORES = 2


def steady_host() -> None:
    """One process with few threads on fixed cores: one intra-op thread, and
    the process kept to two cores (the third and fourth where the machine
    has four or more), so that the host's issue, which paces these cells,
    does not move between cores or wait on spinning pool threads. Call
    before torch is imported."""
    os.environ["OMP_NUM_THREADS"] = "1"
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > HOST_CORES:
        start = HOST_CORES if len(cores) >= 2 * HOST_CORES else 0
        os.sched_setaffinity(0, cores[start:start + HOST_CORES])


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(c, seed: int, seconds: float, traced: bool, device, t_start: float, overrides=None, fault=None) -> dict:
    """One run of cell ``c`` on ``device``: set-up, the window (or the
    profiled one), then the comparison with the reference. Returns the
    result line's object."""
    import torch

    from benchmark.harness import check, flops, timing
    from benchmark.harness import spec
    from benchmark.harness.evaluate import EvalRun
    from benchmark.harness.train import TrainRun

    kind = c.workload["kind"]
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as log_dir:
        run = {"train": TrainRun, "eval": EvalRun}[kind](c, seed, device, log_dir, overrides, fault)
        run.setup()
        setup_s = time.perf_counter() - t_start
        print("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in run.phases) + f"; {setup_s:.3f} s from the start",
              file=sys.stderr)
        if traced:
            ctx = run.traced()
            attempted, failed = ctx["units"], 0
            if any(getattr(spec.reader_module(m["name"]), "WINDOW", False) for m in c.metrics("per_layer")):
                ctx["window"] = run.rate_window(seconds)["metrics"]
        else:
            # the device's busy time a step is taken over the whole window where the cell reports it
            device_time = "step_device_ms" in {m["name"].split(".")[0] for m in c.metrics("end_to_end")}
            out = run.window(seconds, device_time=True) if device_time else run.window(seconds)
            attempted, failed = out["attempted"], out["failed"]
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        program = run.program_outputs()
        run.free()
        readings = run.readings(program, run.reference(program))
    limits = c.workload["limits"]
    correct = check.verdict(readings, limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": c.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        ctx.update(kind=kind, peak_flops=timing.peak_for(c.config["experiment"]["dtype"]))
        if kind == "train":
            ctx["flops"] = flops.train_step(ctx["model"], ctx["batch"])
        else:
            w = c.workload
            ctx["flops"] = flops.eval_image(ctx["model"], w["samples"], w["n_loss"], c.config["data"]["graders"])
        metrics = {}
        for m in c.metrics("per_layer"):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        light = ctx["light"]
        device_info.update(busy_s=light.busy_s, window_s=light.window_s)
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": light.top_ops(), "idle_gaps": ctx["trace"].idle_gaps()})
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        # a metric named <base>.<qualifier> (a group of cells held to a bound of its own) reads <base>
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in c.metrics("end_to_end")}
        result.update(metrics=metrics, device=device_info)
    result["checks"] = check.as_checks(readings, limits)
    return result


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    steady_host()

    import torch

    torch.set_num_threads(1)

    from benchmark.harness import spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 3
    from benchmark.harness import check

    check.report(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
