"""Data parallelism (``unet_zoo_tpu_torch.parallel``, ``Trainer(mesh=)``) on
one card.

* a one-process NCCL group through ``init_distributed``/``make_mesh``: the
  bf16 ``unet`` step at bs64 and ``phiseg_7_5_12`` at bs12 with device
  augmentation, DP_STEPS steps from seed 0, each bit-identical to the plain
  step in which the model draws its own z noise (``own_draws_step``; cuDNN
  deterministic, the resize as matrix products on both sides), 21 launches
  a U-Net step and none in PHiSeg, no host sync inside a step after the
  first;
* DP_RANKS processes on the one card over gloo
  (``tests/torch_dp_card_worker.py``), started together with a time limit:
  each step of ``phiseg_7_5_12`` (f32, global bs12) and of the f32 ``unet``
  (global bs64) against one process's step from the same state and draws,
  the processes bit-identical after each step; ``Trainer.train`` on the two
  processes: process 0 alone validates and writes, the final parameters
  against one process's run.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_card.py
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
from pathlib import Path

import pytest
import torch

from torch_card import (DP_F32_GRAD_L2, DP_PARAM_ATOL_LR, DP_PHISEG_BATCH, DP_RANKS, DP_TRAIN_REL_MOVE, FLIP_SHARE,
                        HARNESS_ITERATIONS, HARNESS_VALIDATION_FREQUENCY, PHISEG_EXPERIMENT, PHISEG_LOSS_RTOL,
                        PHISEG_STATS_RTOL, PHISEG_TRAIN_GRAD_L2, ROUNDING_FLIP_LR, ROUNDING_OF_MAX, TRAIN_BATCH,
                        UNET_LAUNCHES, deterministic, dp_train_config, free_port, lidc_data, no_host_sync, same_state,
                        spawn_workers, train_batches)
from torch_card_checks import card  # noqa: F401  (the fixture)
from torch_dp_card_worker import DP_RANK_STEPS, STEP_CASES
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

WORKER = Path(__file__).resolve().parent / "torch_dp_card_worker.py"
DP_STEPS = 3  # steps of each one-process path from one seed, mesh and plain
DP_TIMEOUT = 600  # seconds for the two processes' whole run


def own_draws_step(tr, x: torch.Tensor, y: torch.Tensor) -> dict:
    """One step of ``tr`` on the whole batch in which the model draws its own
    z noise from the state's generator inside the forward, not the
    Trainer's ``train_noise`` before it (what a one-process step computed
    before data parallelism). Returns the aux dict."""
    from unet_zoo_tpu_torch.training.trainer import LATENT_FAMILIES

    x, y = tr.augment(x, y)
    model = tr.state.model
    model.train()
    loss, aux = model.loss(model(x, y, generator=tr.state.generator) if tr.cfg.model in LATENT_FAMILIES else
                           model(x), y)
    tr.backward(loss)
    tr.update(loss)
    return {k: v.detach() for k, v in aux.items()}


@pytest.mark.parametrize("name,batch,per_step", [("unet", TRAIN_BATCH, UNET_LAUNCHES),
                                                 (PHISEG_EXPERIMENT, DP_PHISEG_BATCH, 0)])
def test_one_process_nccl_mesh_is_the_plain_step(card, tmp_path, name, batch, per_step):
    import torch.distributed as dist

    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh
    from unet_zoo_tpu_torch.training import Trainer

    assert init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda"), "no process group"
    try:
        assert dist.get_backend() == "nccl", f"a one-card group runs {dist.get_backend()}"
        mesh = make_mesh()
        assert mesh.device == card and mesh.world == 1, f"mesh {mesh}"
        cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16", batch_size=batch)
        xs, ys = train_batches(DP_STEPS, card, batch)
        trainers, losses, launches = {}, {}, []
        with deterministic():
            for label in ("plain", "mesh"):
                tr = Trainer(cfg, seed=0, log_dir=str(tmp_path), **({"mesh": mesh} if label == "mesh" else
                                                                   {"device": card}))
                trainers[label], losses[label] = tr, []
                step = tr.train_step if label == "mesh" else functools.partial(own_draws_step, tr)
                for i in range(DP_STEPS):
                    torch.cuda.synchronize()
                    start = conv_chain.launches
                    with no_host_sync() if i else contextlib.nullcontext():
                        losses[label].append(step(xs[i], ys[i])["loss"])
                    torch.cuda.synchronize()
                    if label == "mesh":
                        launches.append(conv_chain.launches - start)
        assert launches == [per_step] * DP_STEPS, f"{name} mesh steps launched {launches}, expected {per_step} each"
        assert torch.equal(torch.stack(losses["plain"]), torch.stack(losses["mesh"])), \
            f"{name}: mesh losses {losses['mesh']} vs plain {losses['plain']}"
        same_state(trainers["plain"].state.state_dict(), trainers["mesh"].state.state_dict(), f"{name} state")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(card, tmp_path_factory):
    """The directory the DP_RANKS worker processes wrote."""
    workdir = tmp_path_factory.mktemp("dp")
    torch.cuda.empty_cache()
    spawn_workers(WORKER, workdir, DP_RANKS, timeout=DP_TIMEOUT)
    return workdir


def params_within(got: dict, want: dict, grads: dict, lr: float, label: str) -> int:
    """Every parameter of ``got`` within DP_PARAM_ATOL_LR lr of ``want`` but
    entries whose gradient (``grads``, the reference's) is rounding, flipped
    by Adam's first update, at most ROUNDING_FLIP_LR lr away; returns how many."""
    flipped = 0
    for n, g in grads.items():
        diff = (got[n].float() - want[n].float()).abs().cpu()
        g = g.abs().cpu()
        off = diff > DP_PARAM_ATOL_LR * lr
        wrong = off & (g > ROUNDING_OF_MAX * g.max())
        assert not bool(wrong.any()), f"{label} {n}: {diff.max().item() / lr:.3f} lr off where the gradient is " \
                                      f"not rounding"
        assert diff.max().item() <= ROUNDING_FLIP_LR * lr, f"{label} {n}: {diff.max().item() / lr:.3f} lr off"
        flipped += int(off.sum())
    return flipped


@pytest.mark.parametrize("name,changes", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_two_processes_match_one(card, ranks, name, changes):
    """Each step of the two processes against one process's step from the
    same state (their checkpoint of the step before) and draws, at PHiSeg's
    train-mode gates or, for the f32 U-Net, DP_F32_GRAD_L2 and the
    parameters within DP_PARAM_ATOL_LR lr; the processes bit-identical."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer, restore_checkpoint

    got_ranks = [torch.load(ranks / f"{name}_{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    cfg = dataclasses.replace(get_experiment(name), **changes)
    xs, ys = train_batches(DP_RANK_STEPS, card, cfg.batch_size)
    one = Trainer(cfg, card, seed=0, log_dir=str(ranks / "one"))
    for i in range(DP_RANK_STEPS):
        label = f"{name} step {i + 1}"
        for r in range(1, DP_RANKS):
            same_state(got_ranks[0][i]["state"], got_ranks[r][i]["state"], f"{label} process {r}")
        if i:
            restore_checkpoint(str(ranks / f"{name}.{i - 1}.pt"), one.state)
        aux = one.train_step(xs[i], ys[i])
        got = got_ranks[0][i]
        want_state = one.state.state_dict()["model"]
        grads = {n: p.grad for n, p in one.state.model.named_parameters()}
        loss_rel = abs(got["loss"] - aux["loss"].item()) / abs(aux["loss"].item())
        g = torch.cat([got["grads"][n].reshape(-1).double() for n in grads]).to(card)
        w = torch.cat([grads[n].reshape(-1).double() for n in grads])
        grad_l2 = ((g - w).norm() / w.norm()).item()
        mine = one.state.state_dict()
        for k in ("generator", "step"):  # the global batch's draws; sched.best is the loss, within its gate
            same_state(mine[k], got["state"][k], f"{label} {k}")
        for k in ("lr", "num_bad"):
            same_state(mine["sched"][k], got["state"]["sched"][k], f"{label} sched.{k}")
        if name == "unet":
            launches = [got_ranks[r][i]["launches"] for r in range(DP_RANKS)]
            assert all(n == UNET_LAUNCHES for n in launches), f"f32 {label}: launches {launches}"
            assert loss_rel <= PHISEG_LOSS_RTOL and grad_l2 <= DP_F32_GRAD_L2, \
                f"f32 {label}: loss rel {loss_rel:.3e}, gradient rel L2 {grad_l2:.3e}"
            flipped = params_within(got["state"]["model"], want_state, grads, cfg.learning_rate, f"f32 {label}")
            assert flipped <= FLIP_SHARE * w.numel(), f"f32 {label}: {flipped} entries flipped"
        else:
            stats = max(((got["state"]["model"][k].float() - v.float()).abs().max() / v.abs().max()).item()
                        for k, v in want_state.items() if "running" in k)
            assert loss_rel <= PHISEG_LOSS_RTOL and grad_l2 <= PHISEG_TRAIN_GRAD_L2 and stats <= PHISEG_STATS_RTOL, \
                f"{label}: loss rel {loss_rel:.3e}, gradient rel L2 {grad_l2:.3e}, running statistics {stats:.3e}"


def test_train_on_two_processes(card, ranks):
    """Process 0 alone validated and wrote; the processes end bit-identical,
    within DP_TRAIN_REL_MOVE of how far one process's run moved the
    parameters from it."""
    from unet_zoo_tpu_torch.training import Trainer

    got_ranks = [torch.load(ranks / f"train_{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    same_state(got_ranks[0]["state"], got_ranks[1]["state"], "train() process 1")
    validations = HARNESS_ITERATIONS // HARNESS_VALIDATION_FREQUENCY
    writes = got_ranks[0]["writes"]
    assert writes.count("validation_ckpt") == validations and all(w.startswith(("validation_ckpt", "best_"))
                                                                  for w in writes), f"process 0 wrote {writes}"
    assert not got_ranks[1]["writes"] and not os.path.exists(ranks / "train1"), \
        f"process 1 wrote {got_ranks[1]['writes']}"
    with open(ranks / "train0" / "metrics_validation.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(ranks / "train0" / "metrics_train.jsonl") as f:
        train_records = [json.loads(line) for line in f]
    steps = [HARNESS_VALIDATION_FREQUENCY * (i + 1) for i in range(validations)]
    assert [r["step"] for r in records] == steps and [r["step"] for r in train_records] == steps, \
        f"metrics records: validation {records}, train {train_records}"
    one = Trainer(dp_train_config(), card, seed=0, log_dir=str(ranks / "train_one"))
    start = {n: p.detach().clone() for n, p in one.state.model.named_parameters()}
    one.train(lidc_data())
    one.close()
    got = got_ranks[0]["state"]["model"]
    moved = math.sqrt(sum((p.detach() - start[n]).double().square().sum().item()
                          for n, p in one.state.model.named_parameters()))
    apart = math.sqrt(sum((got[n].to(card) - p.detach()).double().square().sum().item()
                          for n, p in one.state.model.named_parameters()))
    assert apart <= DP_TRAIN_REL_MOVE * moved, \
        f"train(): {DP_RANKS} processes end {apart:.4e} from one process's parameters, which moved {moved:.4e}"
