"""The CLIs (``unet_zoo_tpu_torch.training.cli``), the caches, the native
loader and host augmentation on the card.

* ``train_main`` then ``eval_main --checkpoint last --num-repeats 1
  --num-samples 4 --generate-images`` in this process for the registered
  ``unet`` (f32), a ``unet`` file in bf16, ``prob_unet``,
  ``phiseg_7_5_12``, ``phiseg_uzh_7_5_192`` and ``phiseg_brats``
  (experiment files of a few iterations with one validation), from a
  synthetic LIDC pickle whose cache the CLI builds and synthetic UZH and
  BraTS caches where ``from_config`` looks: the conv-chain launches of each
  call against the count its steps and images make, the provenance,
  checkpoints, the test sweep's npz with its schema, and the PNGs decoding
  to the model's shape; the caches npy directories where h5py does not
  import; one ``python -m unet_zoo_tpu_torch.train`` in a subprocess;
* ``loader="native"``: the g++ build, batches bit-identical to the
  h5py-loader provider's and 3 ``unet`` steps through each loader with
  bit-identical losses (cuDNN deterministic);
* ``augment_on="host"``: 3 steps where cv2 imports, else the Trainer's
  ImportError.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_card.py
"""

import dataclasses
import importlib.util
import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_card import IMAGE, UNET_LAUNCHES, deterministic, lidc_data
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

REPO = Path(__file__).resolve().parents[1]
CLI_LIDC_CASES = (40, 10)  # the synthetic LIDC pickle: cases, subjects (24 / 8 / 8 images by the 64/16/20 split)
CLI_UZH_SPLITS = (12, 2, 2)  # synthetic UZH slices at 192x192: train (the batch) / validation / test
CLI_BRATS_SPLITS = (2, 1)  # synthetic BraTS volumes at 128^3: train / validation (test empty, as real BraTS)
CLI_VALIDATION_IMAGES = 2
CLI_TEST_SAMPLES = 4  # eval --num-samples
GENERATED = (10, 10)  # generate_images: images, samples each (the method's defaults, as the JAX CLI)
NATIVE_STEPS = 3  # steps of the native-loader and the h5py-loader run, bit-identical
# kernel stages of an image evaluated in float32, folded with their BatchNorm
# sequences (tests/test_torch_fold_card.py): PHiSeg's sample, then its
# eval-mode loss; ProbUNet's prior encoder in the sample, both encoders in
# the loss
PHISEG_FOLDED = (67, 106)
PROB_FOLDED = (21, 42)
# (run, registered experiment, changes, iterations (one validation at the last), launches a step, launches
# an evaluated image, launches a generated image); the conv chain runs in the U-Net and ProbUNet's trunk, and
# in float32 evaluations (one sample fold an image) every 2D BatchNorm sequence folded into it
CLI_RUNS = (
    ("unet", "unet", {}, 2, 21, 21, 21),
    ("unet_bf16", "unet", {"dtype": "bfloat16", "experiment_name": "Unet_bf16"}, 2, 21, 21, 21),
    # an early ProbUNet validation's KL is NaN: validated after 4 steps, as the harness does
    ("prob_unet", "prob_unet", {}, 4, 39, 78 + sum(PROB_FOLDED), 39 + PROB_FOLDED[0]),
    ("phiseg_7_5_12", "phiseg_7_5_12", {}, 2, 0, sum(PHISEG_FOLDED), PHISEG_FOLDED[0]),
    ("phiseg_uzh_7_5_192", "phiseg_uzh_7_5_192", {}, 2, 0, sum(PHISEG_FOLDED), PHISEG_FOLDED[0]),
    ("phiseg_brats", "phiseg_brats", {}, 2, 0, 0, 0),
)


def cli_file(workdir: Path, run: str, name: str, changes: dict, iterations: int) -> str:
    """An experiment file taking the registered ``name`` with a validation at
    ``iterations`` on CLI_VALIDATION_IMAGES images and ``changes``."""
    path = workdir / f"{run}.py"
    changes = dict(validation_frequency=iterations, num_validation_images=CLI_VALIDATION_IMAGES, logging_frequency=1,
                   **changes)
    path.write_text("import dataclasses\n\nfrom unet_zoo_tpu_torch.experiments import get_experiment\n\n"
                    f"config = dataclasses.replace(get_experiment({name!r}), **{changes!r})\n")
    return str(path)


@pytest.fixture(scope="module")
def workdir(card, tmp_path_factory):
    """A system config whose LIDC pickle, UZH and BraTS caches are synthetic."""
    from unet_zoo_tpu_torch.data import brats, synthetic, uzh
    from unet_zoo_tpu_torch.experiments import get_experiment

    workdir = tmp_path_factory.mktemp("cli")
    preproc, preproc_uzh = workdir / "preproc", workdir / "preproc_uzh"
    (workdir / "config.json").write_text(json.dumps({
        "data_root": str(workdir / "data_lidc.pickle"), "preproc_folder": str(preproc),
        "uzh_preproc_folder": str(preproc_uzh), "brats_root": str(workdir / "brats_raw")}))
    synthetic.make_lidc_pickle(str(workdir / "data_lidc.pickle"), num_cases=CLI_LIDC_CASES[0],
                               num_subjects=CLI_LIDC_CASES[1], size=IMAGE, seed=0)
    uzh_cfg, brats_cfg = get_experiment("phiseg_uzh_7_5_192"), get_experiment("phiseg_brats")
    for make, path in ((lambda p: synthetic.make_uzh_cache(p, CLI_UZH_SPLITS, uzh_cfg.image_size[0], 3, seed=0),
                        preproc_uzh / uzh.cache_name(uzh_cfg.image_size, uzh_cfg.target_resolution)),
                       (lambda p: synthetic.make_brats_cache(p, CLI_BRATS_SPLITS, brats_cfg.image_size, seed=0),
                        preproc / brats.cache_name(brats_cfg.image_size))):
        path.parent.mkdir(parents=True, exist_ok=True)
        make(str(path))
    return workdir


def sys_config(workdir: Path):
    from unet_zoo_tpu_torch.experiments import SystemConfig

    return SystemConfig(**json.loads((workdir / "config.json").read_text()))


def check_run_files(run: str, cfg, log_dir: str, n_eval: int) -> None:
    """The files of a train and an eval --generate-images run: the
    provenance, the checkpoints, the test sweep's npz with its schema and
    finite values, and the PNGs (GENERATED images x (image, ground truth,
    samples)), each decoding to the model's (H, W)."""
    from unet_zoo_tpu_torch.utils.png import read_png

    files = sorted(os.listdir(log_dir))
    needed = ["experiment.json", f"{run}.py", "last", "validation_ckpt", "best_metrics.json", "metrics_train.jsonl",
              "metrics_validation.jsonl", "run.log", "samples"]
    assert all(f in files for f in needed) and any(f.startswith("best_") and f != "best_metrics.json" for f in files), \
        f"{run}: files {files}"
    with open(os.path.join(log_dir, "experiment.json")) as f:
        assert json.load(f)["experiment_name"] == cfg.experiment_name, f"{run}: experiment.json"
    brats = cfg.is_3d
    with np.load(os.path.join(log_dir, "brats_test_results.npz" if brats else "test_results.npz")) as f:
        got = {k: f[k] for k in f.files}
    if brats:
        assert {k: v.shape for k, v in got.items()} == {k: (1, n_eval, 3) for k in ("dice", "sensitivity",
                                                                                    "specificity", "hd95")}, \
            f"{run}: brats_test_results {[(k, v.shape) for k, v in got.items()]}"
    else:
        assert {k: v.shape for k, v in got.items()} == {"ged": (1, n_eval), "ncc": (1, n_eval),
                                                        "dice": (1, n_eval, cfg.n_classes)}, \
            f"{run}: test_results {[(k, v.shape) for k, v in got.items()]}"
        assert np.isfinite(got["ged"]).all(), f"{run}: GED {got['ged']}"
    assert np.isfinite(got["dice"]).all() and ((got["dice"] >= 0) & (got["dice"] <= 1)).all(), \
        f"{run}: Dice {got['dice']}"
    pngs = sorted(os.listdir(os.path.join(log_dir, "samples")))
    n_img = min(n_eval, GENERATED[0])
    want = {f"{k}_{i}.png" for i in range(n_img) for k in ("img", "gt")}
    want |= {f"sample_{i}_{s}.png" for i in range(n_img) for s in range(GENERATED[1])}
    assert set(pngs) == want and len(pngs) == n_img * (2 + GENERATED[1]), f"{run}: {len(pngs)} PNGs {pngs[:6]}"
    shapes = {read_png(os.path.join(log_dir, "samples", p)).shape for p in pngs}
    assert shapes == {tuple(cfg.image_size[-3:-1] if brats else cfg.image_size)}, f"{run}: PNG shapes {shapes}"


@pytest.mark.parametrize("run,name,changes,iterations,per_step,per_image,per_generated", CLI_RUNS,
                         ids=[r[0] for r in CLI_RUNS])
def test_train_then_eval(workdir, run, name, changes, iterations, per_step, per_image, per_generated):
    import torch.distributed as dist

    from unet_zoo_tpu_torch.data import data_switch
    from unet_zoo_tpu_torch.experiments import load_experiment
    from unet_zoo_tpu_torch.training.cli import eval_main, train_main

    root = logging.getLogger().handlers[:]
    log_root = str(workdir / "logs")
    common = ["--sys-config", str(workdir / "config.json"), "--log-root", log_root]
    path = cli_file(workdir, run, name, changes, iterations)
    cfg = load_experiment(path)
    torch.cuda.synchronize()
    start = conv_chain.launches
    assert train_main([path, *common, "--iterations", str(iterations)]) == 0, f"{run}: train exit"
    torch.cuda.synchronize()
    train_launches, start = conv_chain.launches - start, conv_chain.launches
    assert eval_main([path, *common, "--checkpoint", "last", "--num-repeats", "1", "--num-samples",
                      str(CLI_TEST_SAMPLES), "--generate-images"]) == 0, f"{run}: eval exit"
    torch.cuda.synchronize()
    eval_launches = conv_chain.launches - start
    assert logging.getLogger().handlers == root and not dist.is_initialized(), \
        f"{run}: the CLI left log handlers or a process group behind"
    data = data_switch(cfg.data_loader).from_config(sys_config(workdir), cfg)  # the split sizes the CLI saw
    if cfg.is_3d:
        n_val = data.num_examples("validation")
        n_eval = data.num_examples("test") or n_val  # the evaluation takes validation where test is empty
    else:
        n_val, n_eval = data.validation.images.shape[0], data.test.images.shape[0]
    del data
    want_train = iterations * per_step + min(CLI_VALIDATION_IMAGES, n_val) * per_image
    want_eval = n_eval * per_image + min(n_eval, GENERATED[0]) * per_generated
    assert (train_launches, eval_launches) == (want_train, want_eval), \
        f"{run}: conv-chain launches train {train_launches} eval {eval_launches}, expected {want_train} {want_eval}"
    log_dir = os.path.join(log_root, cfg.log_dir_name, cfg.experiment_name)
    check_run_files(run, cfg, log_dir, n_eval)
    with open(os.path.join(log_dir, "metrics_train.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == iterations and all(math.isfinite(v) for v in losses), f"{run}: losses {losses}"


def test_caches_are_npy_directories_without_h5py(workdir):
    """The caches are HDF5 files where h5py imports, else npy directories
    (the card's machine has no h5py)."""
    from unet_zoo_tpu_torch.data import data_switch, uzh
    from unet_zoo_tpu_torch.data.cache import find_cache
    from unet_zoo_tpu_torch.experiments import get_experiment

    data_switch("lidc").from_config(sys_config(workdir), get_experiment("unet"))  # builds the LIDC cache
    uzh_cfg = get_experiment("phiseg_uzh_7_5_192")
    caches = [find_cache(str(workdir / "preproc" / "data_lidc.hdf5")),
              find_cache(str(workdir / "preproc_uzh" / uzh.cache_name(uzh_cfg.image_size, uzh_cfg.target_resolution)))]
    if importlib.util.find_spec("h5py") is None:
        assert all(os.path.isdir(c) and c.endswith("_npy") for c in caches), f"caches {caches}"
    else:
        assert all(os.path.isfile(c) for c in caches), f"caches {caches}"


def test_module_entry_point_in_a_subprocess(workdir):
    path = cli_file(workdir, "unet_subprocess", "unet", {}, 2)
    proc = subprocess.run([sys.executable, "-m", "unet_zoo_tpu_torch.train", path, "--sys-config",
                           str(workdir / "config.json"), "--log-root", str(workdir / "subprocess"), "--iterations",
                           "2", "--no-validate"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"python -m unet_zoo_tpu_torch.train exited {proc.returncode}:\n" \
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    assert (workdir / "subprocess" / "lidc" / "Unet" / "last").exists(), "the subprocess wrote no 'last'"


def test_native_loader(workdir):
    """The g++ build, ``next_batch`` on the native and the h5py-loader
    providers (bit-identical), and NATIVE_STEPS steps of a native-loader
    ``unet`` run against the h5py-loader run, losses bit for bit (cuDNN
    deterministic, resize as matrix products)."""
    from unet_zoo_tpu_torch.data import data_switch
    from unet_zoo_tpu_torch.experiments import load_experiment
    from unet_zoo_tpu_torch.native import NativeBatchProvider, store
    from unet_zoo_tpu_torch.training.cli import train_main

    assert store.native_available(), "the native batch store did not build"
    sys_json, log_root = str(workdir / "config.json"), str(workdir / "logs")
    paths = {kind: cli_file(workdir, f"unet_{kind}", "unet", {"experiment_name": f"Unet_{kind}", "loader": kind},
                            NATIVE_STEPS) for kind in ("native", "h5py")}
    cfgs = {kind: load_experiment(p) for kind, p in paths.items()}
    providers = {kind: data_switch("lidc").from_config(sys_config(workdir), cfg).train for kind, cfg in cfgs.items()}
    assert isinstance(providers["native"], NativeBatchProvider), "loader='native' gave no native provider"
    for i in range(NATIVE_STEPS):
        a, b = (providers[k].next_batch(cfgs["native"].batch_size) for k in ("native", "h5py"))
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b)), f"batch {i} differs"
    providers["native"].close()
    losses, launches = {}, {}
    with deterministic():
        for kind, path in paths.items():
            start = conv_chain.launches
            assert train_main([path, "--sys-config", sys_json, "--log-root", log_root, "--iterations",
                               str(NATIVE_STEPS), "--no-validate"]) == 0, f"{kind}: train exit"
            launches[kind] = conv_chain.launches - start
            with open(os.path.join(log_root, "lidc", f"Unet_{kind}", "metrics_train.jsonl")) as f:
                losses[kind] = [json.loads(line)["loss"] for line in f]
    expected = NATIVE_STEPS * UNET_LAUNCHES
    assert launches == {"native": expected, "h5py": expected}, f"native loader runs: launches {launches}"
    assert len(losses["native"]) == NATIVE_STEPS and losses["native"] == losses["h5py"], \
        f"native loader losses {losses['native']} != h5py loader's {losses['h5py']}"


def test_host_augmentation(card, tmp_path):
    """``augment_on="host"``: 3 steps where cv2 imports; where it does not,
    the Trainer's ImportError (never device augmentation)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment("unet"), augment_on="host")
    if importlib.util.find_spec("cv2") is None:
        with pytest.raises(ImportError, match="cv2"):
            Trainer(cfg, card, seed=0, log_dir=str(tmp_path))
        return
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path))
    start = conv_chain.launches
    aux = trainer.train(lidc_data(), iterations=3, validate=False)
    assert math.isfinite(aux["loss"].item()) and conv_chain.launches - start == 3 * UNET_LAUNCHES, \
        f"host augmentation: loss {aux['loss'].item()}, launches {conv_chain.launches - start}"
    trainer.close()
