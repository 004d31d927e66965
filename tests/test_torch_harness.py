"""The port's evaluation and training harness against the JAX package's.

* ``Trainer.eval_image`` against the JAX ``Trainer._eval_image_fn``: the
  U-Net on bridged weights; PHiSeg (the small config of
  ``tests/test_torch_phiseg.py``) by the metrics of the same logits, with
  the JAX function run on them through a stand-in model, and by the
  eval-mode loss on JAX's z noise;
* the annotator picks (``_eval_rng``), the synthetic LIDC data, the LIDC
  cache and the batch providers, number for number;
* validation: the best-per-metric decisions on a scripted sequence, a
  train state left bit-identical, resume toward the total, the test sweep;
* the CLIs on a synthetic LIDC pickle, on the CPU.
"""

import copy
import dataclasses
import json
import logging
import os
import pickle
from types import SimpleNamespace

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_phiseg import CONFIGS as PHISEG_CONFIGS
from test_torch_phiseg import _eps, _jax_model, _run_jit
from test_torch_phiseg import _variables as phiseg_variables
from unet_zoo_tpu.data import synthetic as jax_synthetic
from unet_zoo_tpu.data.batch_provider import BatchProvider as JaxBatchProvider
from unet_zoo_tpu.data.batch_provider import normalise_images as jax_normalise_images
from unet_zoo_tpu.data.batch_provider import resize_batch as jax_resize_batch
from unet_zoo_tpu.data.lidc import LIDCData as JaxLIDCData
from unet_zoo_tpu.data.lidc import prepare_data as jax_prepare_data
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import SystemConfig as JaxSystemConfig
from unet_zoo_tpu.models.unet import UNet as JaxUNet
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu.utils.summary import MetricsWriter as JaxMetricsWriter
from unet_zoo_tpu_torch.bridge import load_jax_params
from unet_zoo_tpu_torch.data import (BatchProvider, BratsData, LIDCData, UZHMatData, UZHProstateData, data_switch,
                                     normalise_images, resize_batch, synthetic)
from unet_zoo_tpu_torch.data.lidc import prepare_data
from unet_zoo_tpu_torch.experiments import ExperimentConfig, SystemConfig, load_experiment
from unet_zoo_tpu_torch.training import Trainer, image_metrics
from unet_zoo_tpu_torch.training.cli import eval_main, train_main
from unet_zoo_tpu_torch.utils.summary import MetricsWriter

SIZE = 32
TINY_UNET = dict(experiment_name="tiny_unet", model="unet", filter_channels=(4, 8, 8, 8), image_size=(SIZE, SIZE),
                 batch_size=2, validation_samples=3, num_validation_images=2)
_SMALL = PHISEG_CONFIGS["small"]
TINY_PHISEG = dict(TINY_UNET, experiment_name="tiny_phiseg", model="phiseg", filter_channels=_SMALL["num_filters"],
                   latent_levels=_SMALL["latent_levels"], image_size=_SMALL["image_size"])
# f32, the same weights and noise: every value of an evaluation within 1e-5
EVAL_ATOL = 1e-5


def _trainer(tmp_path, name="port", tensorboard=False, seed=None, **kw):
    return Trainer(ExperimentConfig(**{**TINY_UNET, **kw}), device="cpu", seed=seed,
                   log_dir=str(tmp_path / name), tensorboard=tensorboard)


def _data(num_per_split=(6, 3, 3), seed=0):
    return LIDCData(synthetic.lidc_splits(num_per_split, SIZE, seed), seed=seed)


def _eval_inputs(n_classes, annotators=4, seed=0):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((1, SIZE + 4, SIZE + 4, 1)).astype(np.float32)
    x = (sum(noise[:, i:i + SIZE, j:j + SIZE] for i in range(5) for j in range(5)) / 5).astype(np.float32)
    y_all = np.stack([np.digitize(x[0, ..., 0] + 0.3 * rng.standard_normal((SIZE, SIZE)),
                                  np.linspace(-0.3, 0.3, n_classes - 1)) for _ in range(annotators)])
    y_all[-1] = 0  # an annotator who sees nothing
    return x, y_all.astype(np.int32), y_all[1:2].astype(np.int32)


def _close(got, want, label):
    for k in ("ged", "ncc", "dice"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=EVAL_ATOL, err_msg=f"{label} {k}")
    for k in ("mean_pred", "sample0"):
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), np.asarray(want[k])), (label, k)


class _LogitsModel:
    """Stands in for the JAX model in ``Trainer._eval_image_fn``: its
    sample is the given logits (1, n, *S, C), so the JAX function's metric
    ops run on them."""

    def __init__(self, logits):
        self.logits = jnp.asarray(logits)

    def sample(self):
        raise AssertionError("only passed as apply's method")

    def apply(self, variables, x, *args, method=None, **kwargs):
        return self.logits if method == self.sample else self.logits[:, 0]

    loss = staticmethod(JaxUNet.loss)


def _jax_metric_ops(logits, x, y_all, y_chosen):
    jcfg = JaxExperimentConfig(experiment_name="stand_in", model="unet", n_classes=logits.shape[-1])
    fn = JaxTrainer._eval_image_fn(SimpleNamespace(cfg=jcfg, model=_LogitsModel(logits), family="unet"),
                                   logits.shape[1])
    return jax.device_get(fn(None, jnp.asarray(x), jnp.asarray(y_all), jnp.asarray(y_chosen), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("n_classes", [2, 3])
def test_image_metrics_match_the_jax_function(n_classes):
    """Random logits of 5 samples through ``image_metrics`` and through the
    JAX ``_eval_image_fn``'s metric ops."""
    x, y_all, y_chosen = _eval_inputs(n_classes, seed=n_classes)
    logits = 2.0 * np.random.default_rng(4).standard_normal((1, 5, SIZE, SIZE, n_classes)).astype(np.float32)
    want = _jax_metric_ops(logits, x, y_all, y_chosen)
    got = image_metrics(torch.from_numpy(logits[0]), torch.from_numpy(y_all), torch.from_numpy(y_chosen[0]))
    _close(got, want, f"{n_classes} classes")


@pytest.mark.parametrize("n_classes", [2, 3])
def test_eval_image_unet_matches_jax(tmp_path, n_classes):
    jtr = JaxTrainer(JaxExperimentConfig(**TINY_UNET, n_classes=n_classes), log_dir=str(tmp_path / "jax"),
                     tensorboard=False)
    x, y_all, y_chosen = _eval_inputs(n_classes)
    want = jax.device_get(jtr._eval_image_fn(3)(jtr.state.variables, jnp.asarray(x), jnp.asarray(y_all),
                                                jnp.asarray(y_chosen), jax.random.PRNGKey(0)))
    tr = _trainer(tmp_path, n_classes=n_classes)
    load_jax_params(tr.state.model, jax.device_get(jtr.state.params))
    got = tr.eval_image(torch.from_numpy(x), torch.from_numpy(y_all), torch.from_numpy(y_chosen), 3)
    assert set(got) == set(want)
    _close(got, want, "unet")
    for k in ("loss", "kl", "recon"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=0, atol=EVAL_ATOL, err_msg=k)


def test_eval_image_phiseg_matches_jax(tmp_path):
    """PHiSeg in eval mode: the metrics of the port's samples against the
    JAX function's metric ops on the same logits; the eval-mode loss of
    ``n_loss`` repeats against JAX's on its own z noise, recovered as
    (z - mu) / sigma and injected."""
    variables = phiseg_variables(_SMALL, seed=3)
    tr = Trainer(ExperimentConfig(**TINY_PHISEG), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    load_jax_params(tr.state.model, variables["params"], variables["batch_stats"])
    x, y_all, y_chosen = _eval_inputs(2, seed=5)
    n, n_loss = 4, 3
    rng = np.random.default_rng(6)
    levels = len(_SMALL["num_filters"]) - _SMALL["latent_levels"]
    eps = [torch.from_numpy(rng.standard_normal((1, n, SIZE >> (lvl + levels), SIZE >> (lvl + levels), 2))
                            .astype(np.float32)) for lvl in range(_SMALL["latent_levels"])]
    jm = _jax_model(_SMALL)
    x_rep, y_rep = np.repeat(x, n_loss, 0), np.repeat(y_chosen, n_loss, 0)

    def forward(v, x, y):
        out = jm.apply(v, x, y, train=False, rngs={"z": jax.random.PRNGKey(7)})
        return out, jm.loss(out, y)[1]

    out, aux = jax.device_get(_run_jit(forward, variables, jnp.asarray(x_rep), jnp.asarray(y_rep)))
    loss_eps = tuple(_eps(out[f"{k}_z"], out[f"{k}_mu"], out[f"{k}_sigma"]) for k in ("post", "prior"))
    tx, ty_all, ty_chosen = (torch.from_numpy(a) for a in (x, y_all, y_chosen))
    got = tr.eval_image(tx, ty_all, ty_chosen, n, n_loss=n_loss, eps=eps, loss_eps=loss_eps)
    for k in ("loss", "kl", "recon"):
        np.testing.assert_allclose(got[k].item(), float(aux[k]), rtol=EVAL_ATOL, err_msg=k)
    with torch.no_grad():
        logits = tr.state.model.sample(tx, n, eps=eps)
    _close(got, _jax_metric_ops(logits.numpy(), x, y_all, y_chosen), "phiseg")
    assert tr.state.model.training  # eval_image restores the mode
    # without eps the noise comes from eval_generator(salt, index): the same
    # image index gives the same numbers, another gives others
    a, b, c = (tr.eval_image(tx, ty_all, ty_chosen, n, index=i) for i in (0, 0, 1))
    assert torch.equal(a["loss"], b["loss"]) and not torch.equal(a["loss"], c["loss"])


@pytest.mark.parametrize("seed,iteration,salt", [(0, 0, 0), (3, 1000, 0), (3, 1000, 1)])
def test_eval_rng_gives_the_jax_picks(seed, iteration, salt):
    ns = SimpleNamespace(seed=seed, iteration=iteration)
    want, got = JaxTrainer._eval_rng(ns, salt), Trainer._eval_rng(ns, salt)
    assert [want.choice([0, 1, 2, 3]) for _ in range(64)] == [got.choice([0, 1, 2, 3]) for _ in range(64)]


def test_synthetic_data_matches_jax(tmp_path):
    jax_path = jax_synthetic.make_lidc_cache(str(tmp_path / "jax.hdf5"), num_per_split=(5, 2, 3), size=SIZE, seed=2)
    path = synthetic.make_lidc_cache(str(tmp_path / "port.hdf5"), num_per_split=(5, 2, 3), size=SIZE, seed=2)
    arrays = synthetic.lidc_splits((5, 2, 3), SIZE, seed=2)
    with h5py.File(jax_path, "r") as want, h5py.File(path, "r") as got:
        for tt in ("train", "val", "test"):
            for name in ("images", "labels", "uids"):
                assert got[tt][name].dtype == want[tt][name].dtype
                assert np.array_equal(got[tt][name][()], want[tt][name][()]) and np.array_equal(
                    arrays[tt][name], want[tt][name][()]), (tt, name)
    # the one-call fixture: LIDCData over a cache written once
    want = jax_synthetic.synthetic_lidc(str(tmp_path), num_per_split=(5, 2, 3), size=SIZE, seed=2)
    (tmp_path / "port").mkdir()
    got = synthetic.synthetic_lidc(str(tmp_path / "port"), num_per_split=(5, 2, 3), size=SIZE, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(got.train.next_batch(4), want.train.next_batch(4)))
    for mod, name in ((jax_synthetic, "jax.pickle"), (synthetic, "port.pickle")):
        mod.make_lidc_pickle(str(tmp_path / name), num_cases=6, num_subjects=3, size=SIZE, seed=1)
    with open(tmp_path / "jax.pickle", "rb") as f, open(tmp_path / "port.pickle", "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k]["series_uid"] == got[k]["series_uid"]
        assert all(np.array_equal(want[k][n], got[k][n]) for n in ("image", "masks"))


def test_prepare_data_matches_jax(tmp_path):
    pkl = synthetic.make_lidc_pickle(str(tmp_path / "lidc.pickle"), num_cases=30, num_subjects=10, size=SIZE)
    jax_prepare_data(pkl, str(tmp_path / "jax.hdf5"), seed=0)
    prepare_data(pkl, str(tmp_path / "port.hdf5"), seed=0)
    with h5py.File(tmp_path / "jax.hdf5", "r") as want, h5py.File(tmp_path / "port.hdf5", "r") as got:
        assert set(got) == set(want) == {"train", "val", "test"}
        for tt in want:
            for name in ("images", "labels", "uids"):
                assert np.array_equal(got[tt][name][()], want[tt][name][()]), (tt, name)


@pytest.mark.parametrize("source", ["hdf5", "arrays"])
@pytest.mark.parametrize("resize_to", [None, (24, 20)])
def test_lidc_batches_match_jax(tmp_path, source, resize_to):
    """Equal seeds give bit-identical batches, over an HDF5 cache and over
    a dict of arrays with its schema."""
    path = jax_synthetic.make_lidc_cache(str(tmp_path / "lidc.hdf5"), num_per_split=(7, 3, 3), size=SIZE, seed=1)
    want = JaxLIDCData(h5py.File(path, "r"), annotator_range=(0, 2, 3), resize_to=resize_to, seed=5)
    src = h5py.File(path, "r") if source == "hdf5" else synthetic.lidc_splits((7, 3, 3), SIZE, seed=1)
    got = LIDCData(src, annotator_range=(0, 2, 3), resize_to=resize_to, seed=5)
    for split, bs in (("train", 3), ("validation", 2), ("train", 3), ("train", 3), ("test", 3), ("train", 2)):
        (xw, yw), (xg, yg) = getattr(want, split).next_batch(bs), getattr(got, split).next_batch(bs)
        assert xg.dtype == xw.dtype and yg.dtype == yw.dtype and np.array_equal(xg, xw) and np.array_equal(yg, yw)
    for (xw, yw), (xg, yg) in zip(want.train.iterate_batches(3), got.train.iterate_batches(3)):
        assert np.array_equal(xg, xw) and np.array_equal(yg, yw)
    assert np.array_equal(got.validation.labels[()], want.validation.labels[()])
    assert np.array_equal(got.test.images[()], want.test.images[()])


def test_provider_helpers_match_jax():
    rng = np.random.default_rng(8)
    imgs = rng.standard_normal((3, 10, 12)).astype(np.float32) * 3 + 1
    assert np.array_equal(normalise_images(imgs), jax_normalise_images(imgs))
    assert np.array_equal(resize_batch(imgs, (7, 15)), jax_resize_batch(imgs, (7, 15)))
    labels = rng.integers(0, 2, (3, 10, 12, 4)).astype(np.uint8)
    kw = dict(add_dummy_dimension=True, num_labels_per_subject=4, normalise=True)
    want = JaxBatchProvider(imgs, labels, np.arange(3), rng=np.random.default_rng(1), **kw)
    got = BatchProvider(imgs, labels, np.arange(3), rng=np.random.default_rng(1), **kw)
    for (xw, yw), (xg, yg) in zip([want.next_batch(2), want.next_batch(2)], [got.next_batch(2), got.next_batch(2)]):
        assert np.array_equal(xg, xw) and np.array_equal(yg, yw)


def test_loader_and_dataset_registry():
    assert data_switch("lidc") is LIDCData
    assert data_switch("brats") is BratsData
    assert data_switch("uzh_prostate") is UZHProstateData
    assert data_switch("uzh_mat") is UZHMatData
    with pytest.raises(ValueError, match="unknown dataset"):
        data_switch("acdc")
    with pytest.raises(NotImplementedError, match="native"):
        LIDCData(synthetic.lidc_splits((2, 1, 1), 8), loader="native")


def _state(tr):
    """A copy of the whole train state: parameters, buffers (running
    statistics), optimizer moments and steps, scheduler, generator, step."""
    return copy.deepcopy(tr.state.state_dict())


def _same(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("model", ["unet", "phiseg"])
def test_validate_leaves_the_train_state_bit_identical(tmp_path, model):
    """A validation draws nothing from the train state's generator and
    changes no parameter, running statistic or optimizer state, so the
    training run after it is the run without it."""
    kw = TINY_PHISEG if model == "phiseg" else TINY_UNET
    data = _data()
    a, b = (Trainer(ExperimentConfig(**kw), device="cpu", log_dir=str(tmp_path / name), tensorboard=False)
            for name in ("a", "b"))
    batches = [tuple(torch.from_numpy(t) for t in data.train.next_batch(2)) for _ in range(2)]
    for tr in (a, b):
        tr.train_step(*batches[0])
    before = _state(a)
    agg = a.validate(data)
    assert np.isfinite([agg[k] for k in ("ged", "ncc", "loss", "dice", "foreground_dice")]).all()
    _same(before, a.state.state_dict())
    assert a.state.model.training
    assert torch.equal(a.train_step(*batches[1])["loss"], b.train_step(*batches[1])["loss"])
    _same(a.state.state_dict(), b.state.state_dict())


def test_best_checkpoints_follow_the_jax_comparisons(tmp_path, monkeypatch):
    """Dice and NCC keep a new best at >=, loss and GED at <= (ties save
    again); ``best_metrics.json`` holds the best so far."""
    tr = _trainer(tmp_path)
    data = _data()
    # per validation: (ged, ncc, loss, per-structure Dice of the 2 images)
    script = [
        (0.5, 0.2, 3.0, [[0.9, 0.4], [0.7, 0.2]]),  # the first saves every best
        (0.5, 0.2, 3.0, [[0.7, 0.2], [0.9, 0.4]]),  # ties save every best again
        (0.6, 0.1, 3.5, [[0.9, 0.1], [0.7, 0.2]]),  # all worse: none
        (0.7, 0.3, 2.5, [[0.95, 0.4], [0.7, 0.2]]),  # dice, loss and ncc better, ged worse
        (0.4, 0.25, 2.6, [[0.9, 0.4], [0.7, 0.2]]),  # ged better alone
    ]
    expect = [["best_dice", "best_loss", "best_ged", "best_ncc"]] * 2 + [[], ["best_dice", "best_loss", "best_ncc"],
                                                                          ["best_ged"]]
    saved = []
    save = tr.save_model
    monkeypatch.setattr(tr, "save_model", lambda name: (saved.append(name), save(name)))
    for (ged, ncc, loss, dice), names in zip(script, expect):
        rows = torch.tensor([[ged, ncc, loss, 0.0, loss] + d for d in dice])
        monkeypatch.setattr(tr, "evaluate_images", lambda *args, rows=rows, **kw: (rows, None))
        saved.clear()
        agg = tr.validate(data)
        assert saved == ["validation_ckpt"] + names
        assert agg["foreground_dice"] == pytest.approx(np.mean([d[1] for d in dice]))
    with open(tmp_path / "port" / "best_metrics.json") as f:
        best = json.load(f)
    assert best == pytest.approx({"iteration": 0, "dice": 0.5625, "loss": 2.5, "ged": 0.4, "ncc": 0.3})
    assert [json.loads(line)["ged"] for line in open(tmp_path / "port" / "metrics_validation.jsonl")] == \
        pytest.approx([s[0] for s in script])


def test_train_resumes_toward_the_total(tmp_path):
    data = _data()
    tr = _trainer(tmp_path, tensorboard=True, validation_frequency=2, logging_frequency=1)
    aux = tr.train(data, iterations=2)
    assert tr.state.step == tr.iteration == 2 and np.isfinite(aux["loss"].item())
    assert tr.best["loss"] < float("inf")  # validated at iteration 2
    tr.close()
    assert tr.validation_writer.tensorboard and os.listdir(tmp_path / "port" / "tb_validation")  # the panels
    tr.save_model("last")
    resumed = _trainer(tmp_path, seed=9, validation_frequency=2, logging_frequency=1)
    resumed.restore("last")
    assert resumed.iteration == 2 and resumed.best == tr.best
    _same(resumed.state.state_dict(), tr.state.state_dict())
    assert resumed.train(data, iterations=3) is not None and resumed.state.step == 3
    assert resumed.train(data, iterations=3) is None and resumed.state.step == 3
    steps = [json.loads(line)["step"] for line in open(tmp_path / "port" / "metrics_train.jsonl")]
    assert steps == [1, 2, 3]
    assert resumed._log_memory() is None  # no device memory on the CPU


def test_pretrained_model_loads_or_starts_fresh(tmp_path):
    data = _data()
    tr = _trainer(tmp_path)
    tr.train(data, iterations=1, validate=False)
    tr.save_model("pretrained")
    loaded = _trainer(tmp_path, seed=4, pretrained_model="pretrained")
    assert loaded.state.step == 1
    _same(loaded.state.model.state_dict(), tr.state.model.state_dict())
    assert _trainer(tmp_path, pretrained_model="missing").state.step == 0


def test_test_sweep_writes_npz(tmp_path):
    data = _data()
    tr = Trainer(ExperimentConfig(**TINY_PHISEG), device="cpu", log_dir=str(tmp_path / "t"), tensorboard=False)
    with pytest.raises(FileNotFoundError, match="best_loss"):
        tr.test(data, num_repeats=2, num_samples=3)
    tr.save_model("best_loss")
    runs = []
    for _ in range(2):
        res = tr.test(data, num_repeats=2, num_samples=3)
        assert set(res) == {"ged", "ncc", "dice", "seconds"}
        with np.load(tmp_path / "t" / "test_results.npz") as f:
            runs.append({k: f[k] for k in f.files})
    assert runs[0]["ged"].shape == runs[0]["ncc"].shape == (2, 3) and runs[0]["dice"].shape == (2, 3, 2)
    assert all(np.array_equal(runs[0][k], runs[1][k], equal_nan=True) for k in ("ged", "ncc", "dice"))
    assert res["ged"][0] == pytest.approx(runs[1]["ged"].mean())


def test_metrics_writer_matches_jax(tmp_path):
    values = {"loss": np.float32(1.5), "ged": 0.25}
    for cls, name in ((JaxMetricsWriter, "jax"), (MetricsWriter, "port")):
        w = cls(str(tmp_path / name), "validation", tensorboard=name == "port")
        w.scalars(3, values)
        w.image(3, "panel", np.zeros((4, 4)))
        w.close()
    read = {n: json.loads((tmp_path / n / "metrics_validation.jsonl").read_text()) for n in ("jax", "port")}
    assert {k: v for k, v in read["port"].items() if k != "time"} == {k: v for k, v in read["jax"].items()
                                                                      if k != "time"}
    assert MetricsWriter(str(tmp_path / "x"), tensorboard=False).tensorboard is False


def test_system_config_and_fields_match_jax(tmp_path):
    assert dataclasses.asdict(SystemConfig()) == dataclasses.asdict(JaxSystemConfig())
    jax_fields = {f.name: f for f in dataclasses.fields(JaxExperimentConfig)}
    for f in dataclasses.fields(ExperimentConfig):
        assert f.name in jax_fields and f.default == jax_fields[f.name].default, f.name
    exp = tmp_path / "exp.py"
    exp.write_text("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                   "config = ExperimentConfig(experiment_name='FromFile', model='unet', filter_channels=(4, 8))\n")
    assert load_experiment(str(exp)).experiment_name == "FromFile"
    assert load_experiment("unet").experiment_name == "Unet"
    exp.write_text("config = 3\n")
    with pytest.raises(TypeError, match="must define config"):
        load_experiment(str(exp))


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


def test_cli_trains_resumes_and_evaluates(tmp_path, monkeypatch, root_logging):
    """``train_main`` and ``eval_main`` on the default paths of
    ``SystemConfig``: the LIDC pickle at data/data_lidc.pickle, its cache
    built by the port's ``prepare_data`` under preproc/."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("data")
    synthetic.make_lidc_pickle("data/data_lidc.pickle", num_cases=20, num_subjects=10, size=SIZE)
    with open("exp.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                "config = ExperimentConfig(experiment_name='CliTiny', model='unet', filter_channels=(4, 8),\n"
                "    image_size=(32, 32), batch_size=2, iterations=5, validation_frequency=2, logging_frequency=1,\n"
                "    num_validation_images=2, validation_samples=2)\n")
    assert train_main(["exp.py", "--iterations", "2", "--log-root", "runs", "--device", "cpu"]) == 0
    log_dir = tmp_path / "runs" / "lidc" / "CliTiny"
    assert (tmp_path / "preproc" / "data_lidc.hdf5").exists()
    for name in ("last", "validation_ckpt", "best_dice", "best_loss", "best_ged", "best_ncc", "best_metrics.json",
                 "metrics_validation.jsonl", "metrics_train.jsonl", "experiment.json", "exp.py", "run.log"):
        assert (log_dir / name).exists(), name
    assert train_main(["exp.py", "--iterations", "3", "--log-root", "runs", "--device", "cpu", "--resume"]) == 0
    assert torch.load(log_dir / "last", weights_only=True)["step"] == 3
    assert eval_main(["exp.py", "--log-root", "runs", "--num-repeats", "1", "--num-samples", "2",
                      "--checkpoint", "last", "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "preproc" / "data_lidc.hdf5", "r") as f:
        n_test = f["test"]["images"].shape[0]
    with np.load(log_dir / "test_results.npz") as f:
        assert f["ged"].shape == f["ncc"].shape == (1, n_test) and f["dice"].shape == (1, n_test, 2)
    # on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_main(["exp.py", "--log-root", "runs", "--checkpoint", "last"])
