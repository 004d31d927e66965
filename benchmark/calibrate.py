"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 [--control] [--fault <name>]

For each seed it builds the cell's set-up, runs what the window's
comparison reads (the compared train steps, or ``check_images`` calls of
the evaluation, through the timed path), frees the program and prints one
JSON line: the numbers of the program against the float32 reference
(``program``), and with ``--control`` those of the reference computed in
TF32 against it (``control``). ``--fault`` plants a fault under the timed
path (train: ``unchanged``, ``half_batch``; eval: ``altered_ncc``,
``altered_ged``, ``altered_dice``). Not run by the benchmark's runs.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(c, seed: int, device, control: bool, fault=None, overrides=None) -> dict:
    from benchmark.harness.evaluate import EvalRun
    from benchmark.harness.train import TrainRun

    with tempfile.TemporaryDirectory() as log_dir:
        run = {"train": TrainRun, "eval": EvalRun}[c.workload["kind"]](c, seed, device, log_dir, overrides, fault)
        run.setup()
        if c.workload["kind"] == "eval":
            run.calls.extend(run.call() for _ in range(c.workload["check_images"]))
        else:
            run.check_steps()
        program = run.program_outputs()
        run.free()
        want = run.reference(program)
        out = {"seed": seed, "fault": fault, "program": run.readings(program, want)}
        if control:
            out["control"] = run.readings(run.reference(program, tf32=True), want)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault")
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("no CUDA card: the readings are the card's", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(c, seed, torch.device("cuda", 0), args.control, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
