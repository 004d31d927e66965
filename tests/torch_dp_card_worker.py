"""One of the DP_RANKS processes of ``tests/test_torch_parallel_card.py``,
sharing one CUDA card over gloo (NCCL takes one process a card); imports
torch and the port only.

    python tests/torch_dp_card_worker.py RANK PORT WORKDIR

Runs, on a data mesh over the processes:

* ``phiseg_7_5_12`` as registered (f32, TF32 off) at global bs12 and the
  f32 ``unet`` at global bs64, DP_RANK_STEPS steps each with augmentation,
  writing each step's loss, launches, gradients and state to
  ``WORKDIR/<experiment>_<RANK>.pt`` and, on process 0, the checkpoint
  before each step to ``WORKDIR/<experiment>.<step>.pt``;
* ``Trainer.train`` (``torch_card.dp_train_config``) with every checkpoint
  write recorded, to ``WORKDIR/train_<RANK>.pt``;

then prints ``DONE <RANK>``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from unittest import mock

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_card import (DP_PHISEG_BATCH, DP_RANKS, PHISEG_EXPERIMENT, TRAIN_BATCH, dp_train_config,  # noqa: E402
                        lidc_data, train_batches)

DP_RANK_STEPS = 2  # steps of each path, each from the two processes' state before it
# (experiment, its changes) of the steps held against one process
STEP_CASES = ((PHISEG_EXPERIMENT, {"batch_size": DP_PHISEG_BATCH}),
              ("unet", {"batch_size": TRAIN_BATCH, "dtype": "float32"}))


def main(rank: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.parallel import batch_spec, init_distributed, make_mesh
    from unet_zoo_tpu_torch.training import Trainer, save_checkpoint
    from unet_zoo_tpu_torch.training import trainer as trainer_module

    assert init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank, device="cuda", backend="gloo"), "no process group"
    assert dist.get_backend() == "gloo", f"two processes on one card run {dist.get_backend()}"
    mesh = make_mesh()
    for name, changes in STEP_CASES:
        cfg = dataclasses.replace(get_experiment(name), **changes)
        xs, ys = train_batches(DP_RANK_STEPS, mesh.device, cfg.batch_size)
        rows = batch_spec(mesh, cfg.batch_size)
        tr = Trainer(cfg, seed=0, log_dir=os.path.join(workdir, f"log{rank}"), mesh=mesh)
        steps = []
        for i in range(DP_RANK_STEPS):
            torch.cuda.synchronize()
            start = conv_chain.launches
            aux = tr.train_step(xs[i][rows], ys[i][rows])
            torch.cuda.synchronize()
            steps.append({"loss": aux["loss"].item(), "launches": conv_chain.launches - start,
                          "grads": {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()},
                          "state": copy.deepcopy(tr.state.state_dict())})
            if rank == 0:
                save_checkpoint(os.path.join(workdir, f"{name}.{i}.pt"), tr.state)
        torch.save(steps, os.path.join(workdir, f"{name}_{rank}.pt"))
        del tr
        torch.cuda.empty_cache()

    writes, save = [], trainer_module.save_checkpoint
    with mock.patch.object(trainer_module, "save_checkpoint", lambda path, st: (writes.append(path), save(path, st))):
        tr = Trainer(dp_train_config(), seed=0, log_dir=os.path.join(workdir, f"train{rank}"), mesh=mesh)
        tr.train(lidc_data())
        tr.close()
    torch.save({"state": copy.deepcopy(tr.state.state_dict()), "writes": [os.path.basename(w) for w in writes]},
               os.path.join(workdir, f"train_{rank}.pt"))
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
