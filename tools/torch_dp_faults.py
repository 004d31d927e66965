#!/usr/bin/env python3
"""The data-parallel card checks' readings with a fault planted, on one CUDA card.

    python3 tools/torch_dp_faults.py    # from the repository root

``tests/test_torch_parallel_card.py`` holds two processes that share the card
over gloo against one process: (b) the first step's loss, gradient (relative L2)
and running statistics of ``phiseg_7_5_12`` (float32, TF32 off, global
batch 12) and the gradient of the float32 ``unet`` (global batch 64), and
(c) the final parameters of ``Trainer.train`` (20 bf16 ``unet`` steps, a
validation every 10) as a share of how far one process's run moved them.
This script reads the same numbers with a fault planted in both processes,
each by patching the trainer module for one run:

* ``unsynced_bn``: BatchNorm's statistics are each process's own rows'
  (``sync_batch_norm`` skipped);
* ``unreduced_grad``: each process steps on its own rows' gradient
  (``all_reduce_grads_`` skipped);
* ``wrong_rows``: both processes train on the first half of every global
  batch (``shard_batch`` returns it);

beside the reading without a fault, and the card's own spread: the
one-process step against itself with cuDNN's algorithms chosen otherwise
(``cudnn.deterministic``, ``cudnn.benchmark``), and with BatchNorm's
statistics by the group's formula (``max(E[x^2] - E[x]^2, 0)`` through a
one-process gloo group) in place of the library's Welford pass. The card
test's limits (``tests/torch_card.py`` ``DP_*``) must lie between the
readings without and with a fault. Prints
a line a reading, each with the card's name and power limit, and all of
them as one JSON object last. Exits 1 without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from unittest import mock

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from torch_card import (DP_PHISEG_BATCH, DP_RANKS, HARNESS_ITERATIONS, PHISEG_EXPERIMENT, TRAIN_BATCH,  # noqa: E402
                        card_line, dp_train_config, free_port, lidc_data, train_batches)

# (b): (experiment, its changes, the faults read)
STEP_CASES = (
    (PHISEG_EXPERIMENT, {"batch_size": DP_PHISEG_BATCH}, ("none", "unsynced_bn", "unreduced_grad")),
    ("unet", {"batch_size": TRAIN_BATCH, "dtype": "float32"}, ("none", "unreduced_grad")),
)
# (c): the faults read
TRAIN_FAULTS = ("none", "wrong_rows", "unreduced_grad")
TIMEOUT = 900  # seconds for the two processes' whole run


def planted(fault: str, module):
    """The patch of the trainer ``module`` that plants ``fault``."""
    if fault == "unsynced_bn":
        return mock.patch.object(module, "sync_batch_norm", lambda model, group: model)
    if fault == "unreduced_grad":
        return mock.patch.object(module, "all_reduce_grads_", lambda mesh, params: None)
    if fault == "wrong_rows":
        return mock.patch.object(module, "shard_batch", lambda mesh, x: x[:len(x) // mesh.data])
    assert fault == "none", fault
    return contextlib.nullcontext()


def step_case(name: str, changes: dict):
    from unet_zoo_tpu_torch.experiments import get_experiment

    return dataclasses.replace(get_experiment(name), **changes)


def first_step(trainer, x, y) -> dict:
    """One train step: the loss, every gradient and running statistic (CPU)."""
    aux = trainer.train_step(x, y)
    model = trainer.state.model
    return {"loss": aux["loss"].item(),
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers() if "running" in n}}


def worker(rank: int, port: int, workdir: str) -> None:
    """One of the two processes: every faulty and fault-free run, written
    to ``WORKDIR/rank<RANK>.pt``."""
    from unet_zoo_tpu_torch.parallel import batch_spec, init_distributed, make_mesh
    from unet_zoo_tpu_torch.training import Trainer
    from unet_zoo_tpu_torch.training import trainer as trainer_module

    assert init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda", backend="gloo"), "no process group"
    mesh = make_mesh()
    out = {}
    for name, changes, faults in STEP_CASES:
        cfg = step_case(name, changes)
        xs, ys = train_batches(1, mesh.device, cfg.batch_size)
        rows = batch_spec(mesh, cfg.batch_size)
        for fault in faults:
            with planted(fault, trainer_module):
                tr = Trainer(cfg, seed=0, log_dir=os.path.join(workdir, f"log{rank}"), mesh=mesh)
                out[(name, fault)] = first_step(tr, xs[0][rows], ys[0][rows])
            del tr
            torch.cuda.empty_cache()
    for fault in TRAIN_FAULTS:
        with planted(fault, trainer_module):
            tr = Trainer(dp_train_config(), seed=0, log_dir=os.path.join(workdir, f"train_{fault}{rank}"), mesh=mesh)
            tr.train(lidc_data())
            tr.close()
        out[("train", fault)] = {n: p.detach().cpu() for n, p in tr.state.model.named_parameters()}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"DONE {rank}", flush=True)


def rel_l2(got: dict, want: dict) -> float:
    g = torch.cat([got[n].reshape(-1).double() for n in want])
    w = torch.cat([want[n].reshape(-1).double() for n in want])
    return ((g - w).norm() / w.norm()).item()


def stats_of_max(got: dict, want: dict) -> float:
    return max(((got[n].float() - w.float()).abs().max() / w.abs().max()).item() for n, w in want.items())


@contextlib.contextmanager
def cudnn(**flags):
    before = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            setattr(torch.backends.cudnn, k, v)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dp_faults: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from unet_zoo_tpu_torch.ops.pallas import _build
    from unet_zoo_tpu_torch.parallel import init_distributed
    from unet_zoo_tpu_torch.parallel.mesh import sync_batch_norm
    from unet_zoo_tpu_torch.training import Trainer

    _build.load()  # once, before the two processes load it
    card = card_line()
    dev = torch.device("cuda", 0)
    readings = {"card": card}
    with tempfile.TemporaryDirectory(prefix="torch_dp_faults_") as workdir:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r), str(port), workdir],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(DP_RANKS)]
        try:
            outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            tail = "\n".join(out.splitlines()[-40:])
            assert p.returncode == 0 and f"DONE {r}" in out, f"process {r} exited {p.returncode}:\n{tail}"
        got = torch.load(os.path.join(workdir, "rank0.pt"), weights_only=False)
        # this process alone, for BatchNorm by the group's formula
        assert init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", backend="gloo"), "no process group"

        # (b): each faulty first step against one process's, and the card's own spread
        for name, changes, faults in STEP_CASES:
            cfg = step_case(name, changes)
            xs, ys = train_batches(1, dev, cfg.batch_size)
            one = {}
            for label, flags in (("default", {}), ("deterministic", {"deterministic": True}),
                                 ("benchmark", {"benchmark": True}), ("group formula", None)):
                with cudnn(**(flags or {})):
                    tr = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
                    if flags is None:
                        sync_batch_norm(tr.state.model, torch.distributed.group.WORLD)
                    one[label] = first_step(tr, xs[0], ys[0])
                del tr
                torch.cuda.empty_cache()
            want = one["default"]
            for label, reading in [*((f"fault {f}", got[(name, f)]) for f in faults),
                                   *((f"one process, cuDNN {k}", one[k]) for k in ("deterministic", "benchmark")),
                                   ("one process, BatchNorm by the group formula", one["group formula"])]:
                r = {"loss_rel": abs(reading["loss"] - want["loss"]) / abs(want["loss"]),
                     "grad_rel_l2": rel_l2(reading["grads"], want["grads"])}
                if want["stats"]:
                    r["stats_of_max"] = stats_of_max(reading["stats"], want["stats"])
                readings[f"(b) {name} {label}"] = r
                print(f"[dp faults] (b) {name} {cfg.dtype} global bs{cfg.batch_size}, first step, {label}, against one "
                      f"process: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()) + f" | card: {card}", flush=True)

        # (c): each faulty train() against one process's
        tr = Trainer(dp_train_config(), dev, seed=0, log_dir=os.path.join(workdir, "train_one"))
        start = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
        tr.train(lidc_data())
        tr.close()
        final = {n: p.detach() for n, p in tr.state.model.named_parameters()}
        moved = math.sqrt(sum((final[n] - start[n]).double().square().sum().item() for n in final))
        for fault in TRAIN_FAULTS:
            apart = math.sqrt(sum((got[("train", fault)][n].to(dev) - final[n]).double().square().sum().item()
                                  for n in final))
            readings[f"(c) train fault {fault}"] = {"apart_of_moved": apart / moved}
            print(f"[dp faults] (c) Trainer.train({HARNESS_ITERATIONS}) bf16 unet bs{TRAIN_BATCH}, fault "
                  f"{fault}: final parameters {apart / moved:.4f} of the distance one process moved them "
                  f"({moved:.4e}) | card: {card}", flush=True)
        torch.distributed.destroy_process_group()
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
