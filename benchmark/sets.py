"""The spreads that the bounds of ``BENCHMARK.json`` are set from, on the
card: sets of runs of one cell, each run its own process, the same seeds in
every set, then the traced runs:

    python3 benchmark/sets.py --workload <name> --seeds 11,12,13,14,15,16 [--sets 2]
        [--trace-seeds 17,18,19] [--seconds <s>] [--out <dir>]

Each run is ``benchmark/run.py`` as the checks run it; its standard output
and error go to ``<out>/<cell>.<set>.<seed>.t<trace>.out|err``. At the end
it prints one JSON line a set: each end-to-end metric's values, median and
spread (the distance between the first and the third quartile, as
``statistics.quantiles(values, n=4)`` gives them, over the median), and the
spread with the run farthest from the median left out. Not run by the
benchmark's runs.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values):
    """The spread with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def one_run(workload, seed, seconds, trace, out, tag):
    stem = os.path.join(out, f"{workload}.{tag}.{seed}.t{trace}")
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    with open(stem + ".out", "w") as so, open(stem + ".err", "w") as se:
        rc = subprocess.run(cmd, stdout=so, stderr=se, cwd=ROOT).returncode
    with open(stem + ".out") as f:
        lines = f.read().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    print(json.dumps({"set": tag, "seed": seed, "trace": trace, "rc": rc,
                      "correct": result and result["correct"],
                      "metrics": result and {k: v["value"] for k, v in result["metrics"].items()}}), flush=True)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated, the same in every set")
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--trace-seeds", default="", help="comma-separated seeds of --trace 1 runs")
    parser.add_argument("--seconds", type=int)
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sets"))
    args = parser.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for k in range(args.sets):
        tag = "AB"[k] if args.sets <= 2 else str(k)
        sets.append((tag, [one_run(args.workload, s, seconds, 0, args.out, tag) for s in seeds]))
    for s in (int(s) for s in args.trace_seeds.split(",") if s):
        one_run(args.workload, s, seconds, 1, args.out, "T")
    for tag, results in sets:
        done = [r for r in results if r is not None]
        summary = {"set": tag, "runs": len(done), "correct": all(r["correct"] for r in done) and len(done) == len(seeds)}
        for name in (done[0]["metrics"] if done else {}):
            values = [r["metrics"][name]["value"] for r in done]
            summary[name] = {"values": values, "median": statistics.median(values)}
            if len(values) >= 3:
                summary[name].update(spread=spread(values), trimmed=trimmed_spread(values))
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
