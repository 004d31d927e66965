"""The port's UZH prostate path against the JAX package's: the helpers, the
cache built from NIfTI case folders, the synthetic cache, ``UZHProstateData``
over HDF5 and over arrays, ``UZHMatData``, the nine ``phiseg_uzh_*``
experiments, three f32 train steps and one image's evaluation of a toy UZH
PHiSeg (3 classes, 6 graders), the windowed evaluation uploads and the CLIs.

Tolerances: the data exact (every dataset's dtype, shape and values, every
batch). The steps: a 7-level toy PHiSeg (filters 2/4/4/4/4/4/4, 5 latent
levels) at 72x72, whose pyramid runs 72 -> 36 -> 18 -> 9 -> 5 -> 3 -> 2,
batch 4, with the experiment's 3-label augmentation on JAX's draws and JAX's
own z noise (``_NoiseTwin``), each step from JAX's state: the loss within
STEP_LOSS_RTOL, the running statistics within STEP_STATS_OF_MAX of their
max, the parameters within STEP_PARAM_ATOL_LR lr but where a gradient entry
cancels to rounding. One image's evaluation against the JAX
``_eval_image_fn`` on the same weights and noise: GED, NCC, Dice and the
loss terms within EVAL_ATOL, the label maps exact. The windowed validation
and test are bit-identical to one window.
"""

import dataclasses
import json
import logging
import os

import flax.linen as nn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_phiseg import _variables
from test_torch_prob_unet import ROUNDING_FLIP_LR, _sync
from unet_zoo_tpu.data import synthetic as jax_synthetic
from unet_zoo_tpu.data import uzh as juzh
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.data import UZHMatData, UZHProstateData, data_switch, synthetic, uzh
from unet_zoo_tpu_torch.data.augment import AugmentOptions
from unet_zoo_tpu_torch.experiments import ExperimentConfig, SystemConfig, get_experiment
from unet_zoo_tpu_torch.training import Trainer
from unet_zoo_tpu_torch.training import trainer as trainer_module
from unet_zoo_tpu_torch.training.cli import _build_data, eval_main, train_main
from unet_zoo_tpu_torch.utils import save_nii

AUG3 = AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=3)
TOY_UZH = dict(experiment_name="toy_uzh", log_dir_name="uzh", model="phiseg", data_loader="uzh_prostate",
               filter_channels=(2, 4, 4, 4, 4, 4, 4), latent_levels=5, n_classes=3, num_labels_per_subject=6,
               image_size=(72, 72), batch_size=4, seed=0)
# the harness's small PHiSeg with UZH's classes and graders
SMALL_UZH = dict(TOY_UZH, experiment_name="small_uzh", filter_channels=(4, 8, 8, 8), latent_levels=3,
                 image_size=(32, 32), validation_samples=3, num_validation_images="all")
# f32 steps at batch 4 (16 values a channel at the 2x2 level), each from
# JAX's state (measured on the CPU): losses 8.0e-7 relative apart at worst,
# running statistics 1.4e-7 of their max, parameters 2.2e-2 lr, in entries
# whose gradient is under 1e-2 of their tensor's max|g|, where Adam's update
# is most sensitive; one entry in 22417, its gradient 3.5e-4 of its tensor's
# max|g| (the loss sums to ~1.8e4, and train-mode BatchNorm over 16 values
# amplifies rounding), took the other sign at the first step, 2 lr away.
STEPS, STEP_LOSS_RTOL, STEP_STATS_OF_MAX, STEP_PARAM_ATOL_LR, FLIP_OF_MAX = 3, 1e-5, 1e-5, 5e-2, 1e-3
EVAL_ATOL = 1e-5


# the helpers

@pytest.mark.parametrize("axes", [(), (6,)], ids=["slice", "graders"])
@pytest.mark.parametrize("target", [(16, 18), (24, 18), (16, 26), (24, 26)],
                         ids=["crop", "pad-x", "pad-y", "pad-both"])
def test_crop_or_pad_matches_jax(axes, target):
    sl = np.random.default_rng(0).standard_normal((20, 22) + axes).astype(np.float32)
    got, want = uzh.crop_or_pad_slice_to_size(sl, *target), juzh.crop_or_pad_slice_to_size(sl, *target)
    assert got.dtype == want.dtype and got.shape == target + axes
    np.testing.assert_array_equal(got, want)


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 300, (12, 14, 3))
    np.testing.assert_array_equal(uzh.normalise_image(img), juzh.normalise_image(img))
    masks = rng.integers(0, 4, (12, 14, 6)).astype(np.uint8)
    for order, sl in ((1, img[..., 0].astype(np.float32)), (0, masks)):
        for scale in ((1.28, 1.12), (0.9, 1.0)):
            got, want = uzh._rescale_slice(sl, scale, order), juzh._rescale_slice(sl, scale, order)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert [uzh.split_for_patient(i) for i in range(41)] == [juzh.split_for_patient(i) for i in range(41)]
    assert uzh.EXPERT_LIST == juzh.EXPERT_LIST


# the cache

def _case_folders(root, ids, seed=2):
    """NIfTI case folders ``888<id>/t2_tse_tra.nii.gz`` and one mask folder an
    expert, written by the port: volumes of a few slices with a pixel size
    other than 1, masks in 0..3 (label 3 is removed), and a stray file and a
    folder the loader skips."""
    rng = np.random.default_rng(seed)
    images, masks = os.path.join(root, "images"), os.path.join(root, "masks")
    os.makedirs(os.path.join(images, "notes"))
    open(os.path.join(images, "8880.txt"), "w").close()
    for exp in uzh.EXPERT_LIST:
        os.makedirs(os.path.join(masks, exp))
    for pid in ids:
        shape = (18 + pid % 3, 14 + pid % 4, 2 + pid % 2)
        affine = np.diag([0.5 + 0.1 * (pid % 4), 0.6 + 0.05 * (pid % 3), 3.0, 1.0])
        os.makedirs(os.path.join(images, f"888{pid}"))
        save_nii(os.path.join(images, f"888{pid}", "t2_tse_tra.nii.gz"),
                 rng.uniform(0, 500, shape).astype(np.float32), affine=affine)
        for exp in uzh.EXPERT_LIST:
            save_nii(os.path.join(masks, exp, f"prostate_{pid:04d}_{exp[-2:]}.nii.gz"),
                     rng.integers(0, 4, shape).astype(np.uint8), affine=affine)
    return images, masks


@pytest.mark.parametrize("ids", [list(range(1, 14)), [1, 2, 3]], ids=["three-splits", "empty-splits"])
def test_prepare_data_matches_jax(tmp_path, ids):
    """Every dataset of the cache (dtype, shape, values), case 9 skipped, an
    empty split written as ``np.asarray([])``."""
    images, masks = _case_folders(str(tmp_path), ids)
    for prep, name in ((uzh.prepare_data, "port"), (juzh.prepare_data, "jax")):
        prep(images, masks, str(tmp_path / f"{name}.hdf5"), (16, 16), (0.625, 0.625))
    with h5py.File(tmp_path / "port.hdf5", "r") as got, h5py.File(tmp_path / "jax.hdf5", "r") as want:
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k][()], want[k][()], err_msg=k)
        assert 9 not in got["patient_id_train"][()] and got["masks_train"][()].max() == 2
        if len(ids) == 3:
            assert got["images_test"].shape == (0,) and got["images_test"].dtype == np.float64


def test_from_config_reads_the_cache_as_jax(tmp_path):
    """``data_switch("uzh_prostate").from_config`` builds the cache from the
    case folders (named by size and resolution) and serves JAX's batches."""
    images, masks = _case_folders(str(tmp_path), [1, 2, 3, 4, 6, 7])
    kw = dict(uzh_input_image_folder=images, uzh_input_mask_folder=masks)
    cfg = ExperimentConfig(**dict(TOY_UZH, image_size=(16, 16)), target_resolution=(0.625, 0.625))
    data = data_switch("uzh_prostate").from_config(SystemConfig(**kw, uzh_preproc_folder=str(tmp_path / "port")), cfg)
    jcfg = JaxExperimentConfig(**dict(TOY_UZH, image_size=(16, 16)), target_resolution=(0.625, 0.625))
    jdata = juzh.UZHProstateData.from_config(
        SystemConfig(**kw, uzh_preproc_folder=str(tmp_path / "jax")), jcfg)
    assert isinstance(data, UZHProstateData)
    assert os.path.exists(tmp_path / "port" / "data_uzh_prostate_16x16_0.625x0.625.hdf5")
    for (x, y), (jx, jy) in zip([data.train.next_batch(3) for _ in range(3)],
                                [jdata.train.next_batch(3) for _ in range(3)]):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    with pytest.raises(NotImplementedError, match="native"):
        UZHProstateData(synthetic.uzh_arrays((2, 1, 1), 8), loader="native")
    with pytest.raises(ValueError, match="unknown loader"):
        UZHProstateData(synthetic.uzh_arrays((2, 1, 1), 8), loader="mmap")


def test_synthetic_cache_matches_jax(tmp_path):
    jax_synthetic.make_uzh_cache(str(tmp_path / "jax.hdf5"), (8, 3, 2), size=24, num_classes=3, seed=4)
    synthetic.make_uzh_cache(str(tmp_path / "port.hdf5"), (8, 3, 2), size=24, num_classes=3, seed=4)
    arrays = synthetic.uzh_arrays((8, 3, 2), 24, 3, seed=4)
    with h5py.File(tmp_path / "port.hdf5", "r") as got, h5py.File(tmp_path / "jax.hdf5", "r") as want:
        assert set(got) == set(want) == set(arrays)
        for k in want:
            assert got[k].dtype == want[k].dtype == arrays[k].dtype, k
            np.testing.assert_array_equal(got[k][()], want[k][()], err_msg=k)
            np.testing.assert_array_equal(arrays[k], want[k][()], err_msg=k)
    assert set(np.unique(np.concatenate([arrays[f"masks_{tt}"].ravel() for tt in uzh.SPLITS]))) == {0, 1, 2}


@pytest.mark.parametrize("source", ["hdf5", "arrays"])
def test_uzh_batches_match_jax(tmp_path, source):
    """Three ``next_batch`` calls with ``resize_to`` and ``annotator_range``,
    and the validation and test arrays, equal the JAX package's."""
    path = str(tmp_path / "u.hdf5")
    jax_synthetic.make_uzh_cache(path, (9, 4, 3), size=20, seed=5)
    kw = dict(annotator_range=(1, 3, 4), resize_to=(24, 16), seed=3)
    jdata = juzh.UZHProstateData(h5py.File(path, "r"), **kw)
    data = UZHProstateData(h5py.File(path, "r") if source == "hdf5" else synthetic.uzh_arrays((9, 4, 3), 20, seed=5),
                           **kw)
    for split in ("train", "validation", "test"):
        for _ in range(3):
            (x, y), (jx, jy) = getattr(data, split).next_batch(2), getattr(jdata, split).next_batch(2)
            assert x.shape == (2, 24, 16, 1) and x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    for split in ("validation", "test"):
        np.testing.assert_array_equal(np.asarray(getattr(data, split).labels), getattr(jdata, split).labels[()])
        np.testing.assert_array_equal(np.asarray(getattr(data, split).images), getattr(jdata, split).images[()])


@pytest.mark.parametrize("graders", [6, 0], ids=["4d-labels", "3d-labels"])
def test_mat_data_matches_jax(tmp_path, graders):
    """``UZHMatData`` over a ``savemat`` file: the 10/100/50 split and three
    batches of each split; 3-D labels give one grader, as in the JAX class."""
    rng = np.random.default_rng(6)
    path = str(tmp_path / "uzh.mat")
    labels = rng.integers(0, 3, (160, 12, 12) + ((graders,) if graders else ())).astype(np.uint8)
    scipy.io.savemat(path, {"images": rng.standard_normal((160, 12, 12)), "labels": labels})
    data, jdata = UZHMatData(path, annotator_range=(0, 2, 5), seed=1), juzh.UZHMatData(path, annotator_range=(0, 2, 5),
                                                                                       seed=1)
    assert [len(getattr(data, s).indices) for s in ("train", "validation", "test")] == [10, 100, 50]
    assert data.validation.labels.shape == (100, 12, 12) + ((graders,) if graders else ())
    for split in ("train", "validation", "test"):
        for _ in range(3):
            (x, y), (jx, jy) = getattr(data, split).next_batch(4), getattr(jdata, split).next_batch(4)
            assert x.shape == (4, 12, 12, 1) and x.dtype == np.float32 and y.shape == (4, 12, 12)
            assert y.dtype == jy.dtype == np.int32
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


# the experiments

@pytest.mark.parametrize("name", [*(f"phiseg_uzh_7_5_{r}" for r in (192, 256, 384, 512)),
                                  *(f"phiseg_uzh_rev_7_5_{r}" for r in (192, 224, 256, 384, 512))])
def test_uzh_experiments_match_jax(name):
    """Every field the port carries has the JAX entry's value."""
    got, want = get_experiment(name), jax_get_experiment(name)
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(got.augmentation_options) == {
        k: v for k, v in dataclasses.asdict(want.augmentation_options).items() if k != "warp_precision"}
    assert got.data_loader == "uzh_prostate" and got.n_classes == 3 and got.num_labels_per_subject == 6
    assert got.model_kwargs()["reversible_mode"] == want.model_kwargs()["reversible_mode"]


# the train step and the evaluation

class _Draws(nn.Module):
    shapes: tuple

    def __call__(self):
        return [jax.random.normal(self.make_rng("z"), s) for s in self.shapes]


class _NoiseTwin(nn.Module):
    """The JAX PHiSeg's ``posterior`` and ``prior`` scopes with their z draws
    alone, in the model's order (coarsest level first): from the same key
    it draws the noise the model draws, so the port takes JAX's own noise
    (checked: it equals (z - mu) / sigma of the model's forward to rounding,
    and ``sample`` decodes it to JAX's logits)."""

    shapes: tuple

    def setup(self):
        self.posterior = _Draws(self.shapes)
        self.prior = _Draws(self.shapes)

    def __call__(self, posterior_only=False):
        return (self.posterior(),) if posterior_only else (self.posterior(), self.prior())

    def sample(self, n):
        vm = nn.vmap(lambda mdl: mdl.prior(), in_axes=(), out_axes=0, axis_size=n,
                     variable_axes={"params": None, "batch_stats": None}, split_rngs={"z": True})
        return vm(self)


def _noise_shapes(cfg, batch):
    """(batch, h, w, zdim) of each latent level, coarsest first: ceil-mode pools."""
    sizes = [cfg["image_size"]]
    for _ in range(len(cfg["filter_channels"]) - 1):
        sizes.append(tuple(-(-s // 2) for s in sizes[-1]))
    first = len(cfg["filter_channels"]) - cfg["latent_levels"]
    return tuple((batch, *sizes[first + lvl], 2) for lvl in reversed(range(cfg["latent_levels"])))


def _noise(cfg, batch, key, posterior_only=False):
    """(posterior, prior) eps lists, finest level first, of a forward keyed
    ``key``; (posterior,) with ``posterior_only`` (a train step's prior
    decodes the posterior's z)."""
    draws = _NoiseTwin(_noise_shapes(cfg, batch)).apply({}, posterior_only, rngs={"z": key})
    return tuple([torch.from_numpy(np.array(d)) for d in reversed(level_draws)] for level_draws in draws)


def _jax_trainer(cfg, tmp_path, seed):
    """A JAX ``Trainer`` of ``cfg`` on numpy-drawn variables (its own init
    would take half a minute op by op)."""
    variables = _variables(dict(num_filters=cfg["filter_channels"], latent_levels=cfg["latent_levels"],
                                image_size=cfg["image_size"], num_classes=cfg["n_classes"]), seed=seed)
    jcfg = JaxExperimentConfig(**cfg, augmentation_options=jax_options(AUG3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        return JaxTrainer(jcfg, log_dir=str(tmp_path / "jax"), tensorboard=False), variables


def _compiled(jitted, *args):
    """A jitted JAX function compiled at XLA's lowest backend optimisation
    level (the same f32 math, about half the compile time)."""
    return jitted.lower(*args).compile({"xla_backend_optimization_level": 0})


def test_train_steps_match_jax_f32(tmp_path):
    """Three f32 steps on JAX's augmentation draws (3 labels) and z noise,
    each from JAX's state before it (``_sync``, as for ProbUNet): the loss
    within STEP_LOSS_RTOL, the running statistics within STEP_STATS_OF_MAX
    of their max, every parameter within STEP_PARAM_ATOL_LR * lr of JAX's
    after the step, except entries whose gradient cancels to rounding
    (within FLIP_OF_MAX of their tensor's max|g|): Adam's first update,
    lr * sign(g), may give those the other sign, up to ROUNDING_FLIP_LR * lr
    away, in at most 1e-3 of all entries."""
    jtr, variables = _jax_trainer(TOY_UZH, tmp_path, seed=0)
    tr = Trainer(ExperimentConfig(**TOY_UZH, augmentation_options=AUG3), device="cpu", log_dir=str(tmp_path / "port"),
                 tensorboard=False)
    data = UZHProstateData(synthetic.uzh_arrays((12, 1, 1), 72, seed=7), seed=0)
    batches = [data.train.next_batch(4) for _ in range(STEPS)]
    assert set(np.unique(np.concatenate([y for _, y in batches]))) == {0, 1, 2}
    params = dict(tr.state.model.named_parameters())
    jstate, lr, step, flipped = jtr.state, jtr.cfg.learning_rate, None, 0
    for i, (x, y) in enumerate(batches):
        _sync(tr, jstate)
        _, k_aug, k_z = jax.random.split(jstate.rng, 3)  # as _step_fn splits it
        draws = jax_draws(k_aug, 4, TOY_UZH["image_size"], AUG3)
        z_eps, = _noise(TOY_UZH, 4, k_z, posterior_only=True)
        step = step or _compiled(jax.jit(jtr._step_fn), jstate, jnp.asarray(x), jnp.asarray(y))
        jstate, jaux = step(jstate, jnp.asarray(x), jnp.asarray(y))
        aux = tr.train_step(torch.from_numpy(x), torch.from_numpy(y), draws, z_eps)
        np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=STEP_LOSS_RTOL, err_msg=f"step {i}")
        assert tr.state.step == int(jstate.step) == i + 1
        want = state_dict_from_jax(jax.device_get(jstate.params), tr.state.model, jax.device_get(jstate.batch_stats))
        for n, t in tr.state.model.state_dict().items():
            diff = (t - want[n]).abs()
            if n not in params:  # a running statistic
                assert diff.max() <= STEP_STATS_OF_MAX * want[n].abs().max(), (i, n)
                continue
            g = params[n].grad.abs()
            off = diff > STEP_PARAM_ATOL_LR * lr
            assert not (off & (g > FLIP_OF_MAX * g.max())).any(), (i, n, diff[off].max().item() / lr)
            assert diff.max() <= ROUNDING_FLIP_LR * lr, (i, n, diff.max().item() / lr)
            flipped += int(off.sum())
    assert flipped <= 1e-3 * sum(p.numel() for p in params.values())


def test_eval_image_matches_jax(tmp_path):
    """One image with 6 graders and 3 classes: the JAX ``_eval_image_fn`` (its
    samples, GED, NCC, Dice and the eval-mode loss of ``n_loss`` repeats)
    against ``Trainer.eval_image`` on the same weights and the same noise."""
    n, n_loss = 4, 3
    jtr, variables = _jax_trainer(SMALL_UZH, tmp_path, seed=3)
    tr = Trainer(ExperimentConfig(**SMALL_UZH), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    load_jax_params(tr.state.model, variables["params"], variables["batch_stats"])
    arrays = synthetic.uzh_arrays((1, 1, 1), 32, seed=8)
    x = arrays["images_validation"][..., None]
    y_all = np.moveaxis(arrays["masks_validation"][0], -1, 0).astype(np.int32)  # (6, H, W)
    y_all[2] = 2 - y_all[2] // 2  # graders that disagree: classes 0, 1 and 2 in one image
    y_chosen = y_all[4:5]
    key = jax.random.PRNGKey(9)
    args = (jtr.state.variables, jnp.asarray(x), jnp.asarray(y_all), jnp.asarray(y_chosen), key)
    want = jax.device_get(_compiled(jtr._eval_image_fn(n, n_loss), *args)(*args))
    sample_eps = [torch.from_numpy(np.moveaxis(np.array(d), 0, 1)) for d in reversed(
        _NoiseTwin(_noise_shapes(SMALL_UZH, 1)).apply({}, n, method=_NoiseTwin.sample, rngs={"z": key}))]
    loss_eps = _noise(SMALL_UZH, n_loss, jax.random.fold_in(key, 1))
    got = tr.eval_image(torch.from_numpy(x), torch.from_numpy(y_all), torch.from_numpy(y_chosen), n, n_loss=n_loss,
                        eps=sample_eps, loss_eps=loss_eps)
    assert set(got) == set(want) and got["dice"].shape == (3,)
    for k in ("ged", "ncc", "dice", "loss", "kl", "recon"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=EVAL_ATOL, atol=EVAL_ATOL, err_msg=k)
    for k in ("mean_pred", "sample0"):
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert len(np.unique(y_all)) == 3


# the windowed evaluation

def _evaluate(tmp_path, monkeypatch, window, data):
    """validate and test (2 repeats) of a fresh seeded trainer with
    ``EVAL_IMAGE_WINDOW`` = ``window``: the rows of each ``evaluate_images``
    call, the host arrays uploaded, the panels, the saved checkpoints and the
    files."""
    monkeypatch.setattr(trainer_module, "EVAL_IMAGE_WINDOW", window)
    log_dir = tmp_path / f"window{window}"
    tr = Trainer(ExperimentConfig(**SMALL_UZH), device="cpu", log_dir=str(log_dir), tensorboard=True)
    seen = {"rows": [], "uploads": [], "panels": [], "saved": []}
    evaluate, to_device, save = tr.evaluate_images, tr._to_device, tr.save_model

    def record(*args, **kwargs):
        rows, maps = evaluate(*args, **kwargs)
        seen["rows"].append(rows.clone())
        return rows, maps

    monkeypatch.setattr(tr, "evaluate_images", record)
    monkeypatch.setattr(tr, "_to_device", lambda a: (seen["uploads"].append((a.dtype, a.shape)), to_device(a))[1])
    monkeypatch.setattr(tr, "save_model", lambda name: (seen["saved"].append(name), save(name)))
    monkeypatch.setattr(tr.validation_writer, "image", lambda step, tag, img: seen["panels"].append((tag, img)))
    agg = tr.validate(data)
    res = tr.test(data, num_repeats=2, num_samples=2, checkpoint="best_loss")
    tr.close()
    with np.load(log_dir / "test_results.npz") as f:
        npz = {k: f[k] for k in f.files}
    with open(log_dir / "metrics_validation.jsonl") as f:
        records = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
    with open(log_dir / "best_metrics.json") as f:
        files = {"metrics_validation.jsonl": records, "best_metrics.json": json.load(f)}
    return dict(seen, agg=agg, test={k: v for k, v in res.items() if k != "seconds"}, npz=npz, files=files)


def test_windowed_evaluation_is_bit_identical(tmp_path, monkeypatch):
    """``validate`` over "all" 7 validation images and ``test`` over 5, in
    windows of 3 and in one window: the same rows, panels, checkpoints,
    aggregates and files, bit for bit; each window's labels go up as uint8."""
    data = UZHProstateData(synthetic.uzh_arrays((4, 7, 5), 32, seed=9), seed=0)
    one, windows = (_evaluate(tmp_path, monkeypatch, w, data) for w in (100, 3))
    assert len(one["rows"]) == 1 + 2 and len(windows["rows"]) == 3 + 2 * 2
    assert torch.equal(torch.cat(windows["rows"][:3]), one["rows"][0])
    assert all(torch.equal(torch.cat(windows["rows"][3 + 2 * r:5 + 2 * r]), one["rows"][1 + r]) for r in range(2))
    assert [(d, s) for d, s in windows["uploads"] if d == np.uint8] == [
        (np.uint8, (n, 6, 32, 32)) for n in (3, 3, 1, 3, 2, 3, 2)]
    assert [(d, s) for d, s in windows["uploads"] if d == np.float32] == [
        (np.float32, (n, 32, 32, 1)) for n in (3, 3, 1, 3, 2, 3, 2)]
    assert [tag for tag, _ in windows["panels"]] == [f"panel_{i}" for i in range(4)]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(windows["panels"], one["panels"]))
    assert windows["saved"] == one["saved"] and windows["agg"] == one["agg"] and windows["test"] == one["test"]
    assert windows["files"] == one["files"]
    assert one["npz"]["dice"].shape == (2, 5, 3)
    assert all(np.array_equal(windows["npz"][k], one["npz"][k], equal_nan=True) for k in one["npz"])


# the CLIs

@pytest.mark.parametrize("name", ["phiseg_uzh_7_5_192", "phiseg_uzh_rev_7_5_224"])
def test_registry_names_reach_the_uzh_cache(tmp_path, name):
    """A registry name's data comes from ``UZHProstateData.from_config``: the
    cache ``data_uzh_prostate_<res>x<res>_0.625x0.625.hdf5`` in
    ``uzh_preproc_folder``, "all" validation images."""
    cfg = get_experiment(name)
    res = cfg.image_size[0]
    synthetic.make_uzh_cache(str(tmp_path / f"data_uzh_prostate_{res}x{res}_0.625x0.625.hdf5"), (3, 2, 1), res)
    data = _build_data(cfg, SystemConfig(uzh_preproc_folder=str(tmp_path)))
    assert isinstance(data, UZHProstateData) and data.validation.images.shape == (2, res, res)
    x, y = data.train.next_batch(2)
    assert x.shape == (2, res, res, 1) and y.shape == (2, res, res)


@pytest.fixture
def root_logging():
    """The CLIs add handlers to the root logger; take them off again."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def test_cli_trains_and_evaluates_uzh(tmp_path, monkeypatch, root_logging):
    """``train_main`` and ``eval_main`` on an experiment file with the UZH
    loader: the cache built from NIfTI case folders, 3-class test results."""
    monkeypatch.chdir(tmp_path)
    images, masks = _case_folders(str(tmp_path / "raw"), [1, 2, 3, 4, 5, 6, 7])
    with open("config.json", "w") as f:
        json.dump({"uzh_input_image_folder": images, "uzh_input_mask_folder": masks, "uzh_preproc_folder": "pre"}, f)
    with open("exp.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                "config = ExperimentConfig(experiment_name='UzhTiny', log_dir_name='uzh', model='phiseg',\n"
                "    data_loader='uzh_prostate', filter_channels=(4, 8), latent_levels=1, n_classes=3,\n"
                "    num_labels_per_subject=6, image_size=(16, 16), target_resolution=(0.625, 0.625), batch_size=2,\n"
                "    validation_frequency=2, logging_frequency=1, num_validation_images='all', validation_samples=2)\n")
    assert train_main(["exp.py", "--iterations", "2", "--log-root", "runs", "--device", "cpu"]) == 0
    assert eval_main(["exp.py", "--log-root", "runs", "--num-repeats", "1", "--num-samples", "2",
                      "--checkpoint", "last", "--device", "cpu"]) == 0
    log_dir = tmp_path / "runs" / "uzh" / "UzhTiny"
    assert (tmp_path / "pre" / "data_uzh_prostate_16x16_0.625x0.625.hdf5").exists()
    with h5py.File(tmp_path / "pre" / "data_uzh_prostate_16x16_0.625x0.625.hdf5", "r") as f:
        n_test, n_val = f["images_test"].shape[0], f["images_validation"].shape[0]
    with open(log_dir / "metrics_validation.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [2]
    with np.load(log_dir / "test_results.npz") as f:
        assert n_val > 0 and f["dice"].shape == (1, n_test, 3)
