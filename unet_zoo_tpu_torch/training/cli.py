"""Command-line entry points of the PyTorch port, the twin of
``unet_zoo_tpu.training.cli``:

    python -m unet_zoo_tpu_torch.train EXP [--local] [--iterations N] [--log-root DIR] [--resume [CKPT]]
    python -m unet_zoo_tpu_torch.eval  EXP [--local] [--checkpoint best_loss] [--num-repeats R] [--num-samples N]
                                           [--export-predictions]

EXP is a registry name (e.g. ``phiseg_7_5_12``) or the path of a ``.py``
file that defines ``config = ExperimentConfig(...)``; the definition is
copied into the log directory. Both run on the CUDA card unless given
``--device cpu``, and raise where there is no card. ``--export-predictions``
(BraTS) writes each evaluated volume's label map as NIfTI after the test
sweep. The JAX CLI's mesh flags (multi-device) and its image export are not
ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys

from unet_zoo_tpu_torch.experiments.config import ExperimentConfig, SystemConfig, load_experiment
from unet_zoo_tpu_torch.training.trainer import Trainer


def setup_logger(log_dir: str) -> logging.Logger:
    """Per-run file and console logging."""
    os.makedirs(log_dir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(fh)
    root.addHandler(sh)
    return root


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


def _setup(args) -> tuple:
    cfg = load_experiment(args.experiment)
    sys_cfg = _load_sys_config(args)
    if args.log_root:
        sys_cfg = dataclasses.replace(sys_cfg, log_root=args.log_root)
    log_dir = os.path.join(sys_cfg.log_root, cfg.log_dir_name, cfg.experiment_name)
    setup_logger(log_dir)
    return cfg, sys_cfg, log_dir


def train_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train a unet_zoo_tpu_torch experiment")
    _common_args(p)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--resume", nargs="?", const="last", default=None, metavar="CKPT",
                   help="resume from a checkpoint in the log dir (default: 'last'): parameters, optimizer, "
                        "scheduler, step, generator and the best metrics so far")
    args = p.parse_args(argv)

    cfg, sys_cfg, log_dir = _setup(args)
    _copy_provenance(args.experiment, cfg, log_dir)

    trainer = Trainer(cfg, device=args.device, sys_config=sys_cfg, log_dir=log_dir)
    try:
        if args.resume is not None:
            trainer.restore(args.resume)
            logging.getLogger(__name__).info("resumed from '%s' at step %d", args.resume, trainer.state.step)
        data = _build_data(cfg, sys_cfg)
        trainer.train(data, iterations=args.iterations, validate=not args.no_validate)
        trainer.save_model("last")
    finally:
        trainer.close()
    return 0


def eval_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate a trained unet_zoo_tpu_torch experiment")
    _common_args(p)
    p.add_argument("--checkpoint", default="best_loss")
    p.add_argument("--num-repeats", type=int, default=10)
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--export-predictions", action="store_true",
                   help="BraTS: write per-case .nii.gz label-map predictions (largest connected component a label, "
                        "reassembled to the original geometry where the cache carries crop offsets)")
    args = p.parse_args(argv)

    cfg, sys_cfg, log_dir = _setup(args)
    if args.export_predictions and not (cfg.is_3d and cfg.data_loader == "brats"):
        p.error("--export-predictions is a BraTS (3D) flow")

    trainer = Trainer(cfg, device=args.device, sys_config=sys_cfg, log_dir=log_dir)
    try:
        data = _build_data(cfg, sys_cfg)
        trainer.test(data, num_repeats=args.num_repeats, num_samples=args.num_samples, checkpoint=args.checkpoint)
        if args.export_predictions:
            trainer.export_predictions(data, num_samples=args.num_samples)
    finally:
        trainer.close()
    return 0
