"""Command-line entry points of the PyTorch port, the twin of
``unet_zoo_tpu.training.cli``:

    python -m unet_zoo_tpu_torch.train EXP [--local] [--iterations N] [--log-root DIR] [--resume [CKPT]] [MESH]
    python -m unet_zoo_tpu_torch.eval  EXP [--local] [--checkpoint best_loss] [--num-repeats R] [--num-samples N]
                                           [--generate-images] [--export-predictions] [MESH]
    MESH: [--mesh data=N[,space=K]] [--space K] [--coordinator HOST:PORT --num-processes N --process-id I]

EXP is a registry name (e.g. ``phiseg_7_5_12``) or the path of a ``.py``
file that defines ``config = ExperimentConfig(...)``; the definition is
copied into the log directory. Both run on the CUDA card unless given
``--device cpu``, and raise where there is no card. The data come from the
experiment's cache (``data.cache``: HDF5 where ``h5py`` imports, else a
directory of ``.npy`` files), built from the raw data on first use. After
the test sweep, ``--generate-images`` writes PNGs of the first 10 test
images, their ground truth and 10 samples of each into ``samples`` in the
log directory (``Trainer.generate_images``; BraTS: mid-depth slices), and
``--export-predictions`` (BraTS) writes each evaluated volume's label map
as NIfTI; both take the method's 10 samples whatever ``--num-samples``
says, as the JAX CLI does.

Data parallelism: the JAX CLI's mesh flags, parsed as it parses them. One
JAX process drives every visible device, a process here drives one card (or
the CPU): so with no flags the run is one process on one card, and
``--mesh data=N`` with N > 1 takes N processes, each started with the same
``--coordinator`` (process 0's HOST:PORT), ``--num-processes N`` and its own
``--process-id``; ``--num-processes N`` alone means ``data=N``. The global
batch (``batch_size``) must split evenly over them. Process 0 alone writes
the log file, the provenance, the metrics and the checkpoints; in ``eval``
it runs the test sweep while the others wait at a barrier. The space axis
(``--space K``, ``--mesh data=N,space=K``) splits each data group's image
height over K processes (``parallel/space.py``): N x K processes in all,
started as above with ``--num-processes N*K``; processes ``d*K`` to
``d*K+K-1`` form data group ``d``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys

from typing import Optional

import torch.distributed as dist

from unet_zoo_tpu_torch.experiments.config import ExperimentConfig, SystemConfig, load_experiment
from unet_zoo_tpu_torch.parallel.mesh import Mesh, barrier, init_distributed, make_mesh, process_index
from unet_zoo_tpu_torch.training.trainer import Trainer


def setup_logger(log_dir: str, to_file: bool = True) -> list:
    """Per-run console logging, and the ``run.log`` file where ``to_file``;
    returns the handlers added to the root logger (``_finish`` takes them
    off again, so that a process running several CLI calls logs each once)."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if to_file:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, "run.log")))
    for handler in handlers:
        handler.setFormatter(fmt)
        root.addHandler(handler)
    return handlers


def _load_sys_config(args) -> SystemConfig:
    """Paths from ``--sys-config``, else ``config.local.json`` with
    ``--local``, else ``config.json``, where the file exists; else the
    defaults."""
    path = args.sys_config or ("config.local.json" if args.local else "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return SystemConfig(**json.load(f))
    return SystemConfig()


def _build_data(cfg: ExperimentConfig, sys_cfg: SystemConfig):
    from unet_zoo_tpu_torch.data.registry import data_switch

    return data_switch(cfg.data_loader).from_config(sys_cfg, cfg)


def _copy_provenance(exp: str, cfg: ExperimentConfig, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    if os.path.exists(exp) and exp.endswith(".py"):
        shutil.copy(exp, log_dir)
    with open(os.path.join(log_dir, "experiment.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def _common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("experiment", help="registry name or path to an experiment .py file")
    p.add_argument("--local", action="store_true", help="use config.local.json")
    p.add_argument("--sys-config", default=None, help="path config json")
    p.add_argument("--log-root", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="mesh 'data=N[,space=K]': N x K processes, one a card, each started with --coordinator, "
                        "--num-processes N*K and its --process-id; 'none' trains each process alone")
    p.add_argument("--space", type=int, default=None, metavar="K",
                   help="split each data group's image height over K processes")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address, the same in every process of a multi-process run")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def make_cli_mesh(args, batch_size: int) -> Optional[Mesh]:
    """The mesh the flags ask for, or None for one process alone: joins the
    process group where ``--coordinator`` or ``--num-processes`` is given,
    then parses ``--mesh``/``--space`` as the JAX CLI does. Fails with a
    message (``SystemExit``) for a bad component, a mesh (data x space) that
    is not the number of processes, or a global batch that does not split
    over the data axis."""
    if args.coordinator is not None or args.num_processes is not None:
        init_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    if args.mesh == "none":
        return None
    data = space = None
    for part in args.mesh.split(",") if args.mesh is not None else ():
        k, sep, v = part.partition("=")
        if not sep or k not in ("data", "space") or not v.isdigit():
            raise SystemExit(f"--mesh: bad component {part!r} (want data=N[,space=K])")
        if k == "data":
            data = int(v)
        else:
            space = int(v)
    if args.space is not None:
        if space is not None and space != args.space:
            raise SystemExit("--space contradicts --mesh's space=")
        space = args.space
    space = space or 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None and space > 1:
        data = max(world // space, 1)
    if data is not None and data * space != world:
        spec = f"data={data}" + (f",space={space}" if space > 1 else "")
        raise SystemExit(f"--mesh {spec} takes {data * space} processes, one a card, each started with "
                         f"--coordinator HOST:PORT --num-processes {data * space} --process-id I; this run has "
                         f"{world}")
    if data is None and world == 1:
        return None
    data = world // space
    if batch_size % data:
        raise SystemExit(f"the global batch {batch_size} does not split evenly over {data} data-parallel processes")
    return make_mesh(data, space=space, device=args.device)


def _setup(args) -> tuple:
    """(experiment, system config, log directory, mesh, log handlers);
    logging, into the log directory on process 0 alone."""
    cfg = load_experiment(args.experiment)
    sys_cfg = _load_sys_config(args)
    if args.log_root:
        sys_cfg = dataclasses.replace(sys_cfg, log_root=args.log_root)
    log_dir = os.path.join(sys_cfg.log_root, cfg.log_dir_name, cfg.experiment_name)
    mesh = make_cli_mesh(args, cfg.batch_size)
    handlers = setup_logger(log_dir, to_file=process_index() == 0)
    return cfg, sys_cfg, log_dir, mesh, handlers


def _trainer(args, cfg, sys_cfg, log_dir, mesh) -> Trainer:
    return Trainer(cfg, device=None if mesh is not None else args.device, sys_config=sys_cfg, log_dir=log_dir,
                   mesh=mesh)


def _finish(trainer: Optional[Trainer], handlers: list) -> None:
    """Closes the metrics streams, leaves the process group and takes the
    run's log handlers off the root logger."""
    if trainer is not None:
        trainer.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    root = logging.getLogger()
    for handler in handlers:
        root.removeHandler(handler)
        handler.close()


def train_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train a unet_zoo_tpu_torch experiment")
    _common_args(p)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--resume", nargs="?", const="last", default=None, metavar="CKPT",
                   help="resume from a checkpoint in the log dir (default: 'last'): parameters, optimizer, "
                        "scheduler, step, generator and the best metrics so far")
    args = p.parse_args(argv)

    cfg, sys_cfg, log_dir, mesh, handlers = _setup(args)
    if process_index() == 0:
        _copy_provenance(args.experiment, cfg, log_dir)

    trainer = None
    try:
        trainer = _trainer(args, cfg, sys_cfg, log_dir, mesh)
        if args.resume is not None:
            trainer.restore(args.resume)
            logging.getLogger(__name__).info("resumed from '%s' at step %d", args.resume, trainer.state.step)
        data = _build_data(cfg, sys_cfg)
        trainer.train(data, iterations=args.iterations, validate=not args.no_validate)
        trainer.save_model("last")
    finally:
        _finish(trainer, handlers)
    return 0


def eval_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate a trained unet_zoo_tpu_torch experiment")
    _common_args(p)
    p.add_argument("--checkpoint", default="best_loss")
    p.add_argument("--num-repeats", type=int, default=10)
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--generate-images", action="store_true",
                   help="after the test sweep, write PNGs of the first 10 test images, their ground truth and 10 "
                        "samples each into 'samples' in the log dir (BraTS: mid-depth slices)")
    p.add_argument("--export-predictions", action="store_true",
                   help="BraTS: write per-case .nii.gz label-map predictions (largest connected component a label, "
                        "reassembled to the original geometry where the cache carries crop offsets)")
    args = p.parse_args(argv)

    cfg, sys_cfg, log_dir, mesh, handlers = _setup(args)
    if args.export_predictions and not (cfg.is_3d and cfg.data_loader == "brats"):
        p.error("--export-predictions is a BraTS (3D) flow")

    trainer = None
    try:
        trainer = _trainer(args, cfg, sys_cfg, log_dir, mesh)
        if trainer.is_main:  # the others wait at the barrier
            data = _build_data(cfg, sys_cfg)
            trainer.test(data, num_repeats=args.num_repeats, num_samples=args.num_samples, checkpoint=args.checkpoint)
            if args.generate_images:
                trainer.generate_images(data)  # the method's 10 samples, as the JAX CLI
            if args.export_predictions:
                trainer.export_predictions(data)  # the method's 10 samples, as the JAX CLI
        barrier("eval")
    finally:
        _finish(trainer, handlers)
    return 0
