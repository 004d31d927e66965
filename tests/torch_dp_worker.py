"""One process of a data-parallel run of the PyTorch port on the CPU (gloo),
for ``tests/test_torch_parallel.py``; imports torch and the port only.

    python tests/torch_dp_worker.py RANK WORLD PORT WORKDIR

Reads its inputs from ``WORKDIR/in.npz``, runs every case below (one
process start serves them all: importing torch and the port takes seconds)
and writes ``WORKDIR/out_<RANK>.npz``, each result under its case's
prefix, then prints ``DONE <RANK>``:

* ``bn.``: a cross-rank ``BatchNorm`` in train mode on this rank's rows of
  ``bn.x``, the sum of its output times ``bn.cot`` differentiated;
* ``<config>.``: ``STEPS`` train steps of each toy of ``CONFIGS`` on this
  rank's rows of the global batches ``steps.x``/``steps.y``: the state and
  the gradient after each, and on process 0 the full train state
  (``WORKDIR/<config>.<step>.pt``, a checkpoint);
* ``world1.<config>.``: the same steps on the whole global batch by a
  Trainer without a mesh (this process alone), and (``plain.<config>.``)
  by the step in which the model draws its own z noise
  (``own_draws_step``), each process taking every other config;
* ``injected.``: one toy PHiSeg step from the weights ``injected.w.*`` and
  the global draws ``injected.aug.*``/``injected.z.*``;
* ``train.``: ``Trainer.train`` on synthetic LIDC with validations, in the
  log directory ``WORKDIR/train<RANK>``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from unet_zoo_tpu_torch.data.augment import AugmentOptions, AugmentParams  # noqa: E402
from unet_zoo_tpu_torch.experiments import ExperimentConfig  # noqa: E402

AUG = AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=2)
BASE = dict(n_classes=2, image_size=(32, 32), seed=0, batch_size=4, augmentation_options=AUG)
# the toy steps: a U-Net, PHiSeg plain and reversible (3 levels, 2 latent
# levels, the trainer tests' tiny PHiSeg) and ProbUNet, global batch 4
CONFIGS = {
    "unet": dict(BASE, experiment_name="dp_unet", model="unet", filter_channels=(4, 8, 8)),
    "phiseg": dict(BASE, experiment_name="dp_phiseg", model="phiseg", filter_channels=(4, 8, 8), latent_levels=2),
    "phiseg_rev": dict(BASE, experiment_name="dp_phiseg_rev", model="phiseg", filter_channels=(4, 8, 8),
                       latent_levels=2, reversible_mode="reversible"),
    "prob_unet": dict(BASE, experiment_name="dp_prob_unet", model="prob_unet", filter_channels=(4, 8, 8),
                      latent_dim=3, no_convs_fcomb=3),
}
STEPS = 3
# Trainer.train: synthetic LIDC (train, validation, test) images, and the run
TRAIN_SPLITS = (8, 2, 2)
TRAIN = dict(experiment_name="dp_train", model="unet", filter_channels=(4, 8), n_classes=2, image_size=(32, 32),
             batch_size=4, iterations=4, validation_frequency=2, num_validation_images=1, validation_samples=2,
             logging_frequency=1, seed=0, augmentation_options=AUG)
# what a process writes into its log directory
MAIN_FILES = {"validation_ckpt", "best_dice", "best_loss", "best_ged", "best_ncc", "best_metrics.json",
              "metrics_train.jsonl", "metrics_validation.jsonl"}


def state_arrays(trainer, prefix: str = "") -> dict:
    """Every parameter and buffer, the scheduler and the generator state."""
    st = trainer.state
    out = {f"{prefix}{k}": v.detach().cpu().numpy().copy() for k, v in st.model.state_dict().items()}
    out.update({f"{prefix}sched.{k}": v.cpu().numpy().copy() for k, v in st.sched._asdict().items()})
    out[f"{prefix}generator"] = st.generator.get_state().numpy()
    return out


def grads(trainer, prefix: str = "") -> dict:
    return {f"{prefix}grad.{n}": p.grad.numpy().copy() for n, p in trainer.state.model.named_parameters()
            if p.grad is not None}


def own_draws_step(tr, x: torch.Tensor, y: torch.Tensor) -> dict:
    """One step of ``tr`` on the whole batch in which the model draws its own
    z noise from the state's generator inside the forward, not the
    Trainer's ``train_noise`` before it: what a one-process step computed
    before data parallelism. Returns the detached aux dict."""
    from unet_zoo_tpu_torch.training.trainer import LATENT_FAMILIES

    x, y = tr.augment(x, y)
    model = tr.state.model
    model.train()
    out = model(x, y, generator=tr.state.generator) if tr.cfg.model in LATENT_FAMILIES else model(x)
    loss, aux = model.loss(out, y)
    tr.backward(loss)
    tr.update(loss)
    return {k: v.detach() for k, v in aux.items()}


def run_steps(cfg: dict, mesh, x: np.ndarray, y: np.ndarray, log_dir: str, prefix: str,
              checkpoints: str = "", own_draws: bool = False) -> dict:
    """``STEPS`` train steps of ``cfg`` on this process's rows of each global
    batch (``mesh`` None: the whole batch, this process alone; with
    ``own_draws``, by ``own_draws_step``): the loss, the state and the
    gradient after each; with ``checkpoints``, the train state's checkpoint
    ``<checkpoints><step>.pt``."""
    from unet_zoo_tpu_torch.parallel import shard_batch
    from unet_zoo_tpu_torch.training import Trainer, save_checkpoint

    tr = Trainer(ExperimentConfig(**cfg), device="cpu", mesh=mesh, tensorboard=False, log_dir=log_dir)
    step = (lambda a, b: own_draws_step(tr, a, b)) if own_draws else tr.train_step
    out = {}
    for i in range(STEPS):
        xi, yi = (a[i] if mesh is None else shard_batch(mesh, a[i]) for a in (x, y))
        aux = step(torch.from_numpy(xi), torch.from_numpy(yi))
        out[f"{prefix}{i}.loss"] = aux["loss"].numpy()
        out.update(state_arrays(tr, f"{prefix}{i}."))
        out.update(grads(tr, f"{prefix}{i}."))
        if checkpoints:
            save_checkpoint(f"{checkpoints}{i}.pt", tr.state)
    return out


def main(rank: int, world: int, port: str, workdir: str) -> None:
    import torch.distributed as dist

    from unet_zoo_tpu_torch.data import LIDCData, synthetic
    from unet_zoo_tpu_torch.ops.norm import BatchNorm
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh, shard_batch
    from unet_zoo_tpu_torch.parallel.mesh import sync_batch_norm
    from unet_zoo_tpu_torch.training import Trainer

    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(device="cpu")
    inputs = dict(np.load(os.path.join(workdir, "in.npz")))
    out = {}

    bn = sync_batch_norm(BatchNorm(inputs["bn.x"].shape[-1]), mesh.group)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn.weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn.bias"]))
    x = torch.from_numpy(shard_batch(mesh, inputs["bn.x"])).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(shard_batch(mesh, inputs["bn.cot"]))).sum().backward()
    out.update({"bn.y": y.detach().numpy(), "bn.x_grad": x.grad.numpy(), "bn.weight_grad": bn.weight.grad.numpy(),
                "bn.bias_grad": bn.bias.grad.numpy(), "bn.mean": bn.running_mean.numpy(),
                "bn.var": bn.running_var.numpy()})

    xs, ys = inputs["steps.x"], inputs["steps.y"]
    for j, (name, cfg) in enumerate(CONFIGS.items()):
        out.update(run_steps(cfg, mesh, xs, ys, os.path.join(workdir, f"log{rank}"), f"{name}.",
                             os.path.join(workdir, f"{name}.") if rank == 0 else ""))
        if j % world == rank:
            log_dir = os.path.join(workdir, f"alone{rank}")
            out.update(run_steps(cfg, None, xs, ys, log_dir, f"world1.{name}."))
            out.update(run_steps(cfg, None, xs, ys, log_dir, f"plain.{name}.", own_draws=True))

    cfg = ExperimentConfig(**CONFIGS["phiseg"])
    tr = Trainer(cfg, device="cpu", mesh=mesh, tensorboard=False, log_dir=os.path.join(workdir, f"log{rank}"))
    tr.state.model.load_state_dict({k[len("injected.w."):]: torch.from_numpy(v) for k, v in inputs.items()
                                    if k.startswith("injected.w.")})
    draws = AugmentParams(*(torch.from_numpy(inputs[f"injected.aug.{f}"]) for f in AugmentParams._fields))
    z_eps = [torch.from_numpy(inputs[f"injected.z.{lvl}"]) for lvl in range(cfg.latent_levels)]
    aux = tr.train_step(*(torch.from_numpy(shard_batch(mesh, inputs[f"injected.{k}"])) for k in ("x", "y")),
                        draws, z_eps)
    out.update({"injected.loss": aux["loss"].numpy(), **state_arrays(tr, "injected."), **grads(tr, "injected.")})

    data = LIDCData(synthetic.lidc_splits(TRAIN_SPLITS, 32, seed=0), seed=0)
    tr = Trainer(ExperimentConfig(**TRAIN), device="cpu", mesh=mesh, tensorboard=False,
                 log_dir=os.path.join(workdir, f"train{rank}"))
    aux = tr.train(data)
    tr.save_model("last")
    tr.close()
    out.update({"train.loss": aux["loss"].numpy(), **state_arrays(tr, "train.")})

    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
