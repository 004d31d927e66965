"""The port's BraTS path against the JAX package's: the data (the split rule,
preprocessing, the cache built from NIfTI case folders, ``BratsData`` over
HDF5 and over arrays, the synthetic cache), the metrics, the post-processing,
the NIfTI files, and the harness (``validate_brats``, ``test_brats``,
``export_predictions`` and the eval CLI with ``--export-predictions``) on a
synthetic 16^3 cache.

Tolerances: the data, the crop and pad, the one-hot, the reassembly, the
largest connected component and the NIfTI round trips exact; HD95 equal;
the soft Dice, sensitivity and specificity within 1e-6 relative. One
volume's evaluation (``eval_volume``) is held against the JAX
``_eval_volume_fn`` on the same weights and z noise: the region metrics and
the loss terms within 1e-4 relative, the thresholded prediction exact. The
harness is held by its keys, its npz schema and its files: the JAX
``Trainer`` and the port's evaluate the same toy PHiSeg3D on the same
numpy-drawn weights.
"""

import dataclasses
import gzip
import json
import logging
import os
from types import SimpleNamespace

import flax.linen as nn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_phiseg import _run_jit
from test_torch_phiseg3d import TINY, _data, _eps, _jax_model, _variables
from unet_zoo_tpu.data import brats as jbrats
from unet_zoo_tpu.data import synthetic as jax_synthetic
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.metrics import brats as jmetrics
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu.utils import nii as jnii
from unet_zoo_tpu.utils import postprocess as jpost
from unet_zoo_tpu_torch import metrics
from unet_zoo_tpu_torch.bridge import load_jax_params
from unet_zoo_tpu_torch.data import brats, synthetic
from unet_zoo_tpu_torch.data.brats import BratsData
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.training import Trainer
from unet_zoo_tpu_torch.training.cli import eval_main
from unet_zoo_tpu_torch.utils import convert_to_onehot, keep_largest_connected_components, load_nii, save_nii

METRIC_RTOL = 1e-6
VOLUME_RTOL = 1e-4
TIE = 1e-5  # no mean probability this close to the 0.5 threshold
EVAL = dict(TINY, validation_samples=2, num_validation_images=2, use_reversible=True)


def _volume_with_border(rng, shape=(20, 22, 18), channels=4):
    """A nonnegative volume inside a zero border of a few voxels."""
    img = np.zeros(shape + (channels,), np.float32)
    img[3:-2, 2:-4, 4:-1] = rng.uniform(0.1, 5.0, (shape[0] - 5, shape[1] - 6, shape[2] - 5, channels))
    img[5:8, 6:9, 7:10] = 0.0  # zeros inside stay zero under normalise_image
    return img


def test_split_rule_and_preprocessing_match_jax():
    assert [brats.test_train_val_split(i) for i in range(40)] == [jbrats.test_train_val_split(i) for i in range(40)]
    rng = np.random.default_rng(0)
    img = _volume_with_border(rng)
    np.testing.assert_array_equal(brats.normalise_image(img), jbrats.normalise_image(img))
    mask = rng.integers(0, 5, img.shape[:3]).astype(np.uint8)
    for got, want in zip(brats.crop_volume_all_dim(img, mask), jbrats.crop_volume_all_dim(img, mask)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(brats.crop_volume_all_dim(img)[1], jbrats.crop_volume_all_dim(img)[1]):
        np.testing.assert_array_equal(got, want)
    for target in ((16, 16, 16), (24, 13, 18), (9, 30, 17)):
        np.testing.assert_array_equal(brats.crop_or_pad_volume(img, target, 4), jbrats.crop_or_pad_volume(img, target, 4))
        np.testing.assert_array_equal(brats.crop_or_pad_volume(mask, target), jbrats.crop_or_pad_volume(mask, target))
    labels = np.array([0, 1, 2, 4])[rng.integers(0, 4, (6, 7, 8))]
    np.testing.assert_array_equal(brats.to_evaluation_onehot(labels), jbrats.to_evaluation_onehot(labels))
    for pred_shape, lo, hi, orig in (((16, 16, 16), (2, 3, 1), (14, 25, 17), (20, 30, 19)),
                                     ((8, 8, 8), (0, 1, 2), (8, 9, 10), (8, 12, 12))):
        pred = rng.integers(0, 5, pred_shape).astype(np.uint8)
        np.testing.assert_array_equal(brats.reassemble_to_original(pred, orig, lo, hi),
                                      jbrats.reassemble_to_original(pred, orig, lo, hi))


def _case_folders(root, n=12, seed=1):
    """Raw BraTS-style case folders of small NIfTI volumes, written by the port."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        case = f"Case_{i:03d}"
        os.makedirs(os.path.join(root, case))
        img = _volume_with_border(rng, (14 + i % 3, 20, 17 + i % 2))
        for c, mod in enumerate(brats.MODALITIES):
            save_nii(os.path.join(root, case, f"{case}_{mod}.nii.gz"), img[..., c])
        if i % 5:  # some cases have no segmentation
            seg = np.array([0, 1, 2, 4], np.uint8)[rng.integers(0, 4, img.shape[:3])]
            save_nii(os.path.join(root, case, f"{case}_seg.nii.gz"), seg)


def test_prepare_data_matches_jax(tmp_path):
    """The cache built from NIfTI case folders (the port's files read by the
    JAX loader too), offsets included, dataset for dataset."""
    _case_folders(str(tmp_path / "raw"))
    for prep, name in ((brats.prepare_data, "port"), (jbrats.prepare_data, "jax")):
        prep(str(tmp_path / "raw"), str(tmp_path / f"{name}.hdf5"), size=(16, 16, 16), keep_offsets=True)
    with h5py.File(tmp_path / "port.hdf5", "r") as got, h5py.File(tmp_path / "jax.hdf5", "r") as want:
        assert set(got) == set(want) and got["images_validation"].shape[0] > 0
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k][()], want[k][()], err_msg=k)


def test_brats_data_matches_jax(tmp_path):
    """``BratsData`` over the same cache: volumes, one-hot and raw labels,
    offsets, the providers' batches and their order; the port's over a dict
    of arrays reads the same; the synthetic cache is JAX's, array for array."""
    path = str(tmp_path / "b.hdf5")
    jax_synthetic.make_brats_cache(path, num_per_split=(5, 3), size=(8, 10, 6), seed=3, keep_offsets=True)
    arrays = synthetic.brats_arrays((5, 3), (8, 10, 6), seed=3, keep_offsets=True)
    with h5py.File(path, "r") as f:
        for k in ("images_train", "masks_train", "pids_validation", "cropHi_validation", "origShape_train"):
            np.testing.assert_array_equal(arrays[k], f[k][()], err_msg=k)
        assert arrays["images_test"].shape == f["images_test"].shape
        want = jbrats.BratsData(f, seed=4)
        got, from_arrays = BratsData(f, seed=4), BratsData(arrays, seed=4)
        for split in ("train", "validation"):
            assert got.num_examples(split) == from_arrays.num_examples(split) == want.num_examples(split)
            for i in range(want.num_examples(split)):
                for onehot in (True, False):
                    for a, b, c in zip(got.get(i, split, onehot), from_arrays.get(i, split, onehot),
                                       want.get(i, split, onehot)):
                        np.testing.assert_array_equal(a, c)
                        np.testing.assert_array_equal(b, c)
                for a, b in zip(got.offsets(i, split), want.offsets(i, split)):
                    np.testing.assert_array_equal(a, b)
        for _ in range(4):  # without replacement, then a refill, from the shared generator
            for a, b, c in zip(got.train.next_batch(2), from_arrays.train.next_batch(2), want.train.next_batch(2)):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, c)
        for a, b in zip(got.batch_iterator(2, "train"), want.batch_iterator(2, "train")):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]
    assert BratsData(synthetic.brats_arrays((1, 1), (4, 4, 4))).offsets(0) is None


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.random((2, 9, 8, 7, 3)).astype(np.float32)
    target = (rng.random((2, 9, 8, 7, 3)) > 0.6).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    for non_squared in (False, True):
        np.testing.assert_allclose(metrics.soft_dice(tp[..., 0], tt[..., 0], non_squared=non_squared).item(),
                                   float(jmetrics.soft_dice(pred[..., 0], target[..., 0], non_squared=non_squared)),
                                   rtol=METRIC_RTOL)
        np.testing.assert_allclose(metrics.brats_dice_loss(tp, tt, non_squared).item(),
                                   float(jmetrics.brats_dice_loss(pred, target, non_squared)), rtol=METRIC_RTOL)
    empty = np.zeros_like(target[0, ..., 0])
    for p, t in ((pred[0, ..., 1], target[0, ..., 1]), (pred[1, ..., 2], empty), (empty, target[1, ..., 0])):
        for fn, jfn in ((metrics.sensitivity, jmetrics.sensitivity), (metrics.specificity, jmetrics.specificity)):
            np.testing.assert_allclose(fn(torch.from_numpy(p), torch.from_numpy(t)).item(), float(jfn(p, t)),
                                       rtol=METRIC_RTOL)
        assert metrics.hd95(p, t) == jmetrics.hd95(p, t)
    assert metrics.hd95(empty, target[0, ..., 0]) == -1.0


def test_postprocess_matches_jax():
    rng = np.random.default_rng(7)
    for shape in ((12, 13, 11), (20, 20)):
        labels = np.array([0, 1, 2, 4], np.uint8)[(rng.random(shape) * 4 * (rng.random(shape) > 0.4)).astype(int)]
        got = keep_largest_connected_components(labels)
        np.testing.assert_array_equal(got, jpost.keep_largest_connected_components(labels))
        assert got.dtype == labels.dtype and set(np.unique(got)) <= set(np.unique(labels))
        np.testing.assert_array_equal(convert_to_onehot(labels, 5), jpost.convert_to_onehot(labels, 5))


@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
def test_nii_files_read_back_in_both_packages(tmp_path, suffix, dtype):
    rng = np.random.default_rng(8)
    data = (rng.random((7, 5, 6)) * 100).astype(dtype)
    affine = np.diag([1.5, 0.8, 2.0, 1.0])
    save_nii(str(tmp_path / f"port{suffix}"), data, affine)
    jnii.save_nii(str(tmp_path / f"jax{suffix}"), data, affine)
    unzip = gzip.decompress if suffix == ".nii.gz" else (lambda b: b)  # a gzip header carries a time stamp
    assert unzip((tmp_path / f"port{suffix}").read_bytes()) == unzip((tmp_path / f"jax{suffix}").read_bytes())
    for got, want in ((load_nii(str(tmp_path / f"jax{suffix}")), jnii.load_nii(str(tmp_path / f"port{suffix}"))),
                      (load_nii(str(tmp_path / f"port{suffix}")), jnii.load_nii(str(tmp_path / f"jax{suffix}")))):
        assert got[0].dtype == want[0].dtype == data.dtype
        np.testing.assert_array_equal(got[0], data)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert tuple(got[2].pixdim) == tuple(want[2].pixdim) and got[2].get_zooms() == want[2].get_zooms()
    with pytest.raises(ValueError, match="NIfTI"):
        (tmp_path / "bad.nii").write_bytes(b"\x00" * 400)
        load_nii(str(tmp_path / "bad.nii"))


def _volume_noise(jm, n):
    """A JAX function of (variables, x, y, key) returning what the JAX
    ``_eval_volume_fn`` draws with that key: ``sample``'s vmapped prior z,
    mu and sigma a sample level with the logits they decode, and the
    eval-mode forward's outputs."""

    def draws(m, x):
        skips, bottom = m.prior.trunk(x, None, train=False)

        def one(mdl, skips, bottom):
            z, mu, sigma = mdl.prior.zpath(skips, bottom, None, train=False)
            return z, mu, sigma, mdl.accumulate_output(mdl.likelihood(z, train=False))

        return nn.vmap(one, in_axes=(None, None), out_axes=0, axis_size=n, split_rngs={"z": True},
                       variable_axes={"params": None, "batch_stats": None})(m, skips, bottom)

    def fn(variables, x, y, key):
        return (jm.apply(variables, x, rngs={"z": key}, method=draws),
                jm.apply(variables, x, n, train=False, method=jm.sample, rngs={"z": key}),
                jm.apply(variables, x, y, train=False, rngs={"z": key}))

    return fn


def test_eval_volume_matches_jax(tmp_path):
    """``eval_volume`` of one 16^3 volume with 4 samples against the JAX
    ``_eval_volume_fn`` on the toy reversible PHiSeg3D: the noise that
    function draws from its key, recovered as (z - mu) / sigma (``sample``'s
    through a vmapped twin keyed alike, whose logits must be ``sample``'s;
    the loss's from the eval-mode forward) and injected. The likelihood
    heads are sharpened (kernels x100) and the first head's bias centres
    each region's logits, so the thresholded prediction mixes the regions
    and no mean probability lies within ``TIE`` of 0.5."""
    n, key = 4, jax.random.PRNGKey(13)
    jm = _jax_model("reversible")
    variables = _variables("reversible", 11)
    heads = variables["params"]["likelihood"]
    for h in ("head0", "head1"):
        heads[h]["conv"] = {"kernel": 100.0 * heads[h]["conv"]["kernel"], "bias": 0.0 * heads[h]["conv"]["bias"]}
    x, y = (a[:1] for a in _data(5))
    args = (jnp.asarray(x), jnp.asarray(y), key)
    noise = jax.jit(_volume_noise(jm, n)).lower(variables, *args).compile({"xla_backend_optimization_level": 0})
    (_, _, _, logits), _, _ = jax.device_get(noise(variables, *args))
    heads["head0"]["conv"]["bias"] = -np.asarray(logits).mean((0, 1, 2, 3, 4)).astype(np.float32)
    (z, mu, sigma, logits), sampled, out = jax.device_get(noise(variables, *args))
    np.testing.assert_array_equal(np.moveaxis(logits, 0, 1), sampled)
    want = jax.device_get(_run_jit(JaxTrainer._eval_volume_fn(SimpleNamespace(model=jm), n), variables, *args))
    probs = np.asarray(jax.nn.softmax(sampled[0], -1)).mean(0)
    assert np.abs(probs - 0.5).min() > TIE
    assert 0.0 < np.asarray(want["pred_bin"]).mean() < 1.0 and 0.0 < np.asarray(want["dice"]).min()

    tr = Trainer(ExperimentConfig(**EVAL), device="cpu", log_dir=str(tmp_path), tensorboard=False)
    load_jax_params(tr.state.model, variables["params"], variables["batch_stats"])
    eps = [torch.from_numpy(np.moveaxis(np.asarray((a - b) / c), 0, 1)) for a, b, c in zip(z, mu, sigma)]
    loss_eps = tuple(_eps(out[f"{k}_z"], out[f"{k}_mu"], out[f"{k}_sigma"]) for k in ("post", "prior"))
    got = tr.eval_volume(torch.from_numpy(x), torch.from_numpy(y), n, eps=eps, loss_eps=loss_eps)
    assert set(got) == set(want)
    for k in ("dice", "sens", "spec", "loss", "kl", "recon"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=VOLUME_RTOL, err_msg=k)
    assert got["pred_bin"].dtype == torch.bool
    np.testing.assert_array_equal(got["pred_bin"].numpy(), np.asarray(want["pred_bin"]))
    assert tr.state.model.training  # eval_volume restores the mode


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """The JAX Trainer's and the port's ``validate``, ``test`` and
    ``export_predictions`` on one synthetic 16^3 cache with crop offsets,
    the same toy reversible PHiSeg3D weights on both sides."""
    tmp = tmp_path_factory.mktemp("brats_harness")
    path = synthetic.make_brats_cache(str(tmp / "cache.hdf5"), num_per_split=(2, 2), size=(16, 16, 16), seed=9,
                                      keep_offsets=True)
    variables = _variables("reversible", 11)
    runs = {}
    with h5py.File(path, "r") as f:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
            jtr = JaxTrainer(JaxExperimentConfig(**EVAL), log_dir=str(tmp / "jax"), tensorboard=False)
        tr = Trainer(ExperimentConfig(**EVAL), device="cpu", log_dir=str(tmp / "port"), tensorboard=False)
        load_jax_params(tr.state.model, variables["params"], variables["batch_stats"])
        for name, trainer, data in (("jax", jtr, jbrats.BratsData(f, seed=0)), ("port", tr, BratsData(f, seed=0))):
            runs[name] = dict(agg=trainer.validate(data), test=trainer.test(data, num_repeats=2, num_samples=2,
                                                                             checkpoint=None),
                              paths=trainer.export_predictions(data, num_samples=2), log_dir=str(tmp / name),
                              offsets=[data.offsets(i, "validation") for i in range(2)])
    return runs


def test_validate_and_test_match_jax_schema(harness_runs):
    jax_run, port = harness_runs["jax"], harness_runs["port"]
    assert set(port["agg"]) == set(jax_run["agg"]) and len(port["agg"]) == 16
    assert all(np.isfinite(v) for v in port["agg"].values())
    assert all(0.0 <= port["agg"][f"dice_{r}"] <= 1.0 for r in ("wt", "tc", "et"))
    assert set(port["test"]) == set(jax_run["test"])
    for key in ("dice_per_region", "sensitivity_per_region", "specificity_per_region", "hd95_per_region"):
        assert len(port["test"][key]) == len(jax_run["test"][key]) == 3
    for name in ("validation_ckpt", "best_dice", "best_loss", "brats_test_results.npz", "metrics_validation.jsonl"):
        assert os.path.exists(os.path.join(port["log_dir"], name)), name
    with np.load(os.path.join(port["log_dir"], "brats_test_results.npz")) as got, \
            np.load(os.path.join(jax_run["log_dir"], "brats_test_results.npz")) as want:
        assert set(got.files) == set(want.files) == {"dice", "sensitivity", "specificity", "hd95"}
        for k in want.files:
            assert got[k].shape == want[k].shape == (2, 2, 3) and got[k].dtype == want[k].dtype, k
    with open(os.path.join(port["log_dir"], "metrics_validation.jsonl")) as f:
        assert set(json.loads(f.readline())) - {"time", "step"} == set(port["agg"])


def test_export_predictions_match_jax_files(harness_runs):
    """The same file names; each volume in the original geometry, uint8
    BraTS labels, nothing outside the recorded crop box."""
    jax_run, port = harness_runs["jax"], harness_runs["port"]
    assert [os.path.basename(p) for p in port["paths"]] == [os.path.basename(p) for p in jax_run["paths"]]
    for path, jpath, (lo, hi, orig) in zip(port["paths"], jax_run["paths"], port["offsets"]):
        vol, want = load_nii(path)[0], jnii.load_nii(jpath)[0]
        assert vol.shape == want.shape == tuple(orig) and vol.dtype == want.dtype == np.uint8
        assert set(np.unique(vol)) <= {0, 1, 2, 4}
        outside = np.ones(vol.shape, bool)
        outside[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = False
        assert not vol[outside].any()


def test_export_builds_brats_labels_and_keeps_the_largest_component(tmp_path):
    """The export's label map from the thresholded WT/TC/ET prediction (ET 4,
    TC without ET 1, WT without TC 2), largest component a label, on a
    stand-in ``eval_volume``; without offsets the grid's own geometry."""
    tr = Trainer(ExperimentConfig(**EVAL), device="cpu", log_dir=str(tmp_path), tensorboard=False)
    pred = np.zeros((16, 16, 16, 3), bool)
    pred[2:12, 2:12, 2:12, 0] = True  # WT
    pred[4:10, 4:10, 4:10, 1] = True  # TC
    pred[5:7, 5:7, 5:7, 2] = True  # ET
    pred[14:16, 14:16, 14:16, 0] = True  # a second, smaller WT component
    tr.eval_volume = lambda *a, **k: {"pred_bin": torch.from_numpy(pred)}
    data = BratsData(synthetic.brats_arrays((1, 1), (16, 16, 16)), seed=0)
    (path,) = tr.export_predictions(data, num_samples=2)
    vol = load_nii(path)[0]
    want = np.zeros((16, 16, 16), np.uint8)
    want[2:12, 2:12, 2:12] = 2
    want[4:10, 4:10, 4:10] = 1
    want[5:7, 5:7, 5:7] = 4
    np.testing.assert_array_equal(vol, want)


@pytest.fixture
def root_logging():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def test_eval_cli_exports_ten_samples_whatever_num_samples_says(tmp_path, monkeypatch, root_logging):
    """``eval_main --num-samples 2 --export-predictions``: the test sweep
    decodes 2 samples a volume, the export the method's default of 10, as
    the JAX CLI calls ``trainer.export_predictions(data)``."""
    import inspect

    from unet_zoo_tpu_torch.training import cli

    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(ExperimentConfig(**EVAL), experiment_name="CliBratsSamples")
    with open("exp.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                f"config = ExperimentConfig(**{ {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}!r})\n")
    calls = {}
    monkeypatch.setattr(cli, "_build_data", lambda *args: "data")
    monkeypatch.setattr(Trainer, "test", lambda self, data, **kw: calls.setdefault("test", kw["num_samples"]))
    export = Trainer.export_predictions

    def recorded(self, *args, **kwargs):
        bound = inspect.signature(export).bind(self, *args, **kwargs)
        bound.apply_defaults()
        calls["export"] = bound.arguments["num_samples"]

    monkeypatch.setattr(Trainer, "export_predictions", recorded)
    assert eval_main(["exp.py", "--log-root", "runs", "--num-samples", "2", "--device", "cpu",
                      "--export-predictions"]) == 0
    assert calls == {"test": 2, "export": 10}


def test_eval_cli_exports_predictions(tmp_path, monkeypatch, root_logging):
    """``eval_main --export-predictions`` end to end on the CPU: the BraTS
    cache found under ``preproc_folder`` as the system config names it,
    ``best_loss`` restored, the sweep's npz and one NIfTI file a volume."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("preproc")
    synthetic.make_brats_cache("preproc/data_brats18_16x16x16.hdf5", num_per_split=(2, 2), size=(16, 16, 16),
                               keep_offsets=True)
    with open("sys.json", "w") as f:
        json.dump({"brats_root": "raw", "preproc_folder": "preproc"}, f)
    cfg = dataclasses.replace(ExperimentConfig(**EVAL), experiment_name="CliBrats")
    with open("exp.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                f"config = ExperimentConfig(**{ {k: v for k, v in dataclasses.asdict(cfg).items() if v is not None}!r})\n")
    log_dir = tmp_path / "runs" / "brats" / "CliBrats"
    tr = Trainer(cfg, device="cpu", log_dir=str(log_dir), tensorboard=False)
    data = BratsData(synthetic.brats_arrays((2, 2), (16, 16, 16)), seed=0)
    tr.train_step(*(torch.from_numpy(a) for a in data.train.next_batch(2)))
    tr.save_model("best_loss")
    tr.close()
    args = ["exp.py", "--sys-config", "sys.json", "--log-root", "runs", "--num-repeats", "1", "--num-samples", "2",
            "--device", "cpu"]
    assert eval_main(args + ["--export-predictions"]) == 0
    with np.load(log_dir / "brats_test_results.npz") as f:
        assert f["dice"].shape == (1, 2, 3)
    assert sorted(os.listdir(log_dir / "predictions")) == ["prediction_0.nii.gz", "prediction_1.nii.gz"]
    assert load_nii(str(log_dir / "predictions" / "prediction_0.nii.gz"))[0].dtype == np.uint8
    with open("lidc.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                "config = ExperimentConfig(experiment_name='Lidc', model='unet', filter_channels=(4, 8))\n")
    with pytest.raises(SystemExit):
        eval_main(["lidc.py", "--log-root", "runs", "--device", "cpu", "--export-predictions"])
