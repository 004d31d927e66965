"""The port's caches, PNG export, chunked sampling, profiling helpers and
CLIs, on the CPU.

* the npy cache against the HDF5 cache, for the LIDC, UZH and BraTS
  preprocessing (``h5py`` hidden by a ``sys.modules`` entry): the same
  keys, dtypes and bytes; which cache is read; atomic writes;
* ``data.cache.train_test_split`` against scikit-learn's;
* ``Trainer.generate_images`` against the JAX method (a toy U-Net on
  bridged weights), for PHiSeg with injected noise and for BraTS slices;
  the PNG writer against PIL;
* chunked PHiSeg sampling in ``eval_image``, bit for bit against the whole
  fold;
* ``utils.profiling`` on the CPU;
* ``train`` then ``eval --generate-images`` through the CLIs in a
  subprocess where ``h5py``, ``sklearn``, ``PIL``, ``cv2`` and
  ``tensorboardX`` do not import, as on the card's machine.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from unet_zoo_tpu.data.lidc import prepare_data as jax_prepare_data
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import load_jax_params
from unet_zoo_tpu_torch.data import BratsData, LIDCData, brats, cache, lidc, synthetic, uzh
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.training import Trainer
from unet_zoo_tpu_torch.training import trainer as trainer_module
from unet_zoo_tpu_torch.training.cli import eval_main
from unet_zoo_tpu_torch.utils import device_memory_stats, profiling, read_png, save_nii, step_memory_analysis, write_png

REPO = Path(__file__).resolve().parents[1]
SIZE = 16
TOY_UNET = dict(experiment_name="toy_unet", model="unet", filter_channels=(4, 8, 8), image_size=(SIZE, SIZE),
                batch_size=2, validation_samples=2, num_validation_images=2)
TOY_PHISEG = dict(TOY_UNET, experiment_name="toy_phiseg", model="phiseg", latent_levels=2)
TOY_BRATS = dict(experiment_name="toy_brats", log_dir_name="brats", model="phiseg3d", data_loader="brats",
                 filter_channels=(2, 4, 4), latent_levels=2, n_classes=3, num_labels_per_subject=1, input_channels=4,
                 batch_size=1, image_size=(8, 8, 8), use_reversible=True)
# the U-Net's f32 forward on the CPU, the port against JAX on the same weights
FORWARD_ATOL = 1e-5
HIDDEN = ("h5py", "sklearn", "PIL", "cv2", "tensorboardX")


def _leaves(data, prefix=""):
    """{path: array} of every dataset of an open cache, read into memory."""
    out = {}
    for k in data:
        v = data[k]
        if hasattr(v, "keys"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v[()])
    return out


def _same_cache(npy_dir, h5_path):
    with h5py.File(h5_path, "r") as f:
        want = _leaves(f)
    npc = cache.NpyCache(npy_dir)
    got = _leaves(npc)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    return npc


def _uzh_folders(root, ids=(1, 2, 3, 4)):  # no test case: an empty split
    rng = np.random.default_rng(0)
    images, masks = os.path.join(root, "images"), os.path.join(root, "masks")
    for exp in uzh.EXPERT_LIST:
        os.makedirs(os.path.join(masks, exp))
    for pid in ids:
        shape = (18, 14, 2)
        affine = np.diag([0.5, 0.6, 3.0, 1.0])
        os.makedirs(os.path.join(images, f"888{pid}"))
        save_nii(os.path.join(images, f"888{pid}", "t2_tse_tra.nii.gz"),
                 rng.uniform(0, 500, shape).astype(np.float32), affine=affine)
        for exp in uzh.EXPERT_LIST:
            save_nii(os.path.join(masks, exp, f"prostate_{pid:04d}_{exp[-2:]}.nii.gz"),
                     rng.integers(0, 4, shape).astype(np.uint8), affine=affine)
    return images, masks


def _brats_folders(root, n=8):
    rng = np.random.default_rng(1)
    for i in range(n):
        case = f"Case_{i:03d}"
        os.makedirs(os.path.join(root, case))
        img = np.zeros((12, 14, 10, 4), np.float32)
        img[2:-2, 3:-2, 1:-2] = rng.uniform(0.1, 5.0, (8, 9, 7, 4))
        for c, mod in enumerate(brats.MODALITIES):
            save_nii(os.path.join(root, case, f"{case}_{mod}.nii.gz"), img[..., c])
        save_nii(os.path.join(root, case, f"{case}_seg.nii.gz"),
                 np.array([0, 1, 2, 4], np.uint8)[rng.integers(0, 4, img.shape[:3])])


@pytest.mark.parametrize("loader", ["lidc", "uzh", "brats"])
def test_npy_cache_equals_the_hdf5_cache(tmp_path, monkeypatch, loader):
    """Each loader's preprocessing writes HDF5 where h5py imports and the npy
    directory where it does not: the same keys, dtypes, shapes and bytes
    (UZH's empty float64 split and uint8 patient ids, BraTS's offsets);
    the npy arrays are memory-mapped and read-only."""
    if loader == "lidc":
        synthetic.make_lidc_pickle(str(tmp_path / "lidc.pickle"), num_cases=20, num_subjects=10, size=SIZE)
        prep = lambda out: lidc.prepare_data(str(tmp_path / "lidc.pickle"), out, seed=0)  # noqa: E731
    elif loader == "uzh":
        images, masks = _uzh_folders(str(tmp_path))
        prep = lambda out: uzh.prepare_data(images, masks, out, (16, 16), (0.625, 0.625))  # noqa: E731
    else:
        _brats_folders(str(tmp_path / "raw"))
        prep = lambda out: brats.prepare_data(str(tmp_path / "raw"), out, size=(8, 8, 8),  # noqa: E731
                                              keep_offsets=True)
    assert prep(str(tmp_path / "cache.hdf5")) == str(tmp_path / "cache.hdf5")
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not cache.h5py_available()
    written = prep(str(tmp_path / "cache.hdf5"))
    assert written == str(tmp_path / "cache_npy") and os.path.isdir(written)
    monkeypatch.delitem(sys.modules, "h5py")
    npc = _same_cache(written, str(tmp_path / "cache.hdf5"))
    key = "train/images" if loader == "lidc" else "images_train"
    arr = npc[key]
    assert isinstance(arr, np.memmap) and not arr.flags.writeable
    if loader == "uzh":
        assert npc["images_test"].shape == (0,) and npc["images_test"].dtype == np.float64
        assert npc["patient_id_train"].dtype == np.uint8


def test_cache_rules(tmp_path, monkeypatch):
    """Which cache is read: HDF5 where it exists and h5py imports; the npy
    directory where h5py does not (built beside an HDF5 file it cannot
    read); LIDCData batches equal on both."""
    arrays = synthetic.lidc_splits((6, 2, 2), SIZE, seed=3)
    path = str(tmp_path / "data_lidc.hdf5")
    builds = []
    build = lambda p: builds.append(cache.write_cache(p, arrays))  # noqa: E731
    f = cache.load_or_build(path, build)
    assert isinstance(f, h5py.File) and builds == [path]
    assert cache.load_or_build(path, build).filename == f.filename and len(builds) == 1  # read, not rebuilt
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(FileNotFoundError, match="h5py does not import"):
        cache.open_cache(path)
    npc = cache.load_or_build(path, build)
    assert isinstance(npc, cache.NpyCache) and builds[-1] == str(tmp_path / "data_lidc_npy")
    assert "train" in npc and "train/images" in npc and "nothing" not in npc and sorted(npc) == ["test", "train", "val"]
    monkeypatch.delitem(sys.modules, "h5py")
    assert cache.find_cache(path) == path  # h5py back: the HDF5 file again
    a, b = LIDCData(h5py.File(path, "r"), seed=4), LIDCData(npc, seed=4)
    for _ in range(4):
        (xa, ya), (xb, yb) = a.train.next_batch(2), b.train.next_batch(2)
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    assert np.array_equal(a.test.images[1], b.test.images[1])


_KILLED_WRITER = """
import os, signal, sys
import numpy as np
sys.path.insert(0, {repo!r})
sys.modules["h5py"] = None
from unet_zoo_tpu_torch.data import cache
saves = []
def save(path, arr):
    saves.append(path)
    if len(saves) == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    np.lib.format.write_array(open(path, "wb"), arr)
cache.np.save = save
cache.write_cache({path!r}, {{"a": np.zeros(3), "b": np.ones(3), "c": np.ones(2)}})
"""


def test_cache_write_is_atomic(tmp_path, monkeypatch):
    """A writer killed mid-way leaves no cache that a later run reads, and
    the next build completes; a failed write leaves nothing behind."""
    path = str(tmp_path / "c.hdf5")
    proc = subprocess.run([sys.executable, "-c", _KILLED_WRITER.format(repo=str(REPO), path=path)], timeout=60)
    assert proc.returncode == -9
    assert cache.find_cache(path) is None and not os.path.exists(cache.npy_dir(path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = cache.load_or_build(path, lambda p: cache.write_cache(p, {"a": np.arange(3)}))
    assert np.array_equal(out["a"], np.arange(3))

    def broken(p, arr):
        raise OSError("disk full")

    monkeypatch.setattr(cache.np, "save", broken)
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(OSError, match="disk full"):
        cache.write_cache(str(tmp_path / "d.hdf5"), {"a": np.arange(3)})
    assert sorted(os.listdir(tmp_path)) == before


@pytest.mark.parametrize("seed", range(6))
def test_train_test_split_matches_sklearn(seed):
    """The subject split without scikit-learn: equal to sklearn's for many
    sizes and seeds, at LIDC's test_size 0.2 and others."""
    from sklearn.model_selection import train_test_split as sk_split

    for n in range(2, 120):
        a = np.asarray([f"subject_{i:03d}" for i in range(n)])
        for test_size in (0.2, 0.35):
            if int(np.ceil(test_size * n)) >= n:
                continue
            got, want = cache.train_test_split(a, test_size, seed), sk_split(a, test_size=test_size,
                                                                            random_state=seed)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), (n, test_size)
    with pytest.raises(ValueError, match="empty split"):
        cache.train_test_split(np.arange(3), 0.9, seed)


def test_prepare_data_without_h5py_or_sklearn_matches_jax(tmp_path, monkeypatch):
    """LIDC preprocessing with neither h5py nor sklearn (the card's machine)
    writes the npy cache of the JAX package's HDF5 cache, byte for byte."""
    pkl = synthetic.make_lidc_pickle(str(tmp_path / "lidc.pickle"), num_cases=30, num_subjects=15, size=SIZE, seed=5)
    jax_prepare_data(pkl, str(tmp_path / "jax.hdf5"), seed=0)
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    written = lidc.prepare_data(pkl, str(tmp_path / "port.hdf5"), seed=0)
    monkeypatch.delitem(sys.modules, "h5py")
    _same_cache(written, str(tmp_path / "jax.hdf5"))


def _pil(path):
    return np.asarray(Image.open(path))


def _expected_png(arr):
    """JAX's to_png normalisation (its PIL file, decoded)."""
    arr = np.asarray(arr, dtype=np.float32)
    lo, hi = arr.min(), arr.max()
    return ((arr - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)


def test_png_writer_decodes_through_pil(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((1, 1), (7, 13), (64, 48)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        write_png(str(tmp_path / "a.png"), a)
        Image.fromarray(a).save(tmp_path / "pil.png")
        assert np.array_equal(_pil(tmp_path / "a.png"), a) and np.array_equal(read_png(str(tmp_path / "a.png")), a)
        assert np.array_equal(_pil(tmp_path / "a.png"), _pil(tmp_path / "pil.png"))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "b.png"), np.zeros((4, 4), np.float32))


def _lidc_test_split(n=3, seed=1):
    split = synthetic.lidc_splits((2, 1, n), SIZE, seed=seed)["test"]
    return SimpleNamespace(test=SimpleNamespace(images=split["images"], labels=split["labels"]))


def test_generate_images_unet_matches_jax(tmp_path):
    """A toy U-Net on the JAX trainer's weights: every PNG the JAX method
    saves decodes to the port's, but for sample pixels whose top-2 logit
    gap is under FORWARD_ATOL (none at this seed)."""
    data = _lidc_test_split()
    jtr = JaxTrainer(JaxExperimentConfig(**TOY_UNET), log_dir=str(tmp_path / "jax"), tensorboard=False)
    jtr.generate_images(data, num_samples=2, out_dir=str(tmp_path / "jax_png"), max_images=2)
    tr = Trainer(ExperimentConfig(**TOY_UNET), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    load_jax_params(tr.state.model, jax.device_get(jtr.state.params))
    assert tr.generate_images(data, num_samples=2, out_dir=str(tmp_path / "png"), max_images=2) == str(
        tmp_path / "png")
    names = sorted(os.listdir(tmp_path / "jax_png"))
    assert names == sorted(os.listdir(tmp_path / "png")) and len(names) == 2 * (2 + 2)
    with torch.inference_mode():
        logits = tr.state.model.eval()(torch.from_numpy(data.test.images[:2].astype(np.float32))[..., None])
    top2 = logits.topk(2, dim=-1).values
    close = (top2[..., 0] - top2[..., 1] < FORWARD_ATOL).numpy()
    for name in names:
        got, want = read_png(str(tmp_path / "png" / name)), _pil(tmp_path / "jax_png" / name)
        differ = got != want
        if name.startswith("sample_"):
            differ &= ~close[int(name.split("_")[1])]
        assert got.shape == (SIZE, SIZE) and not differ.any(), name
    assert np.array_equal(read_png(str(tmp_path / "png" / "img_1.png")), _expected_png(data.test.images[1]))


def _phiseg_eps(model, x, n, gen):
    """Noise for ``sample(x, n, eps=)``: (1, n, *s, zdim) a latent level."""
    with torch.inference_mode():
        skips, bottom = model.prior.trunk(x)
    L = model.latent_levels
    skips = skips[len(skips) - (L - 1):]
    spatial = [bottom.shape[1:-1]] + [skips[-k].shape[1:-1] for k in range(1, L)]
    return [torch.randn((1, n, *s, model.prior.zdim), generator=gen) for s in spatial][::-1]


def test_generate_images_phiseg_noise(tmp_path):
    """PHiSeg's sample PNGs are the argmax of ``sample`` with the injected
    noise, or with ``eval_generator(GENERATE_SALT, i)``'s; the labels'
    first annotator is the ground truth; all images with ``max_images=None``."""
    data = _lidc_test_split(n=2, seed=2)
    tr = Trainer(ExperimentConfig(**TOY_PHISEG), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    model = tr.state.model
    x = torch.from_numpy(data.test.images.astype(np.float32))[..., None]
    gen = torch.Generator().manual_seed(3)
    eps = [_phiseg_eps(model, x[i:i + 1], 3, gen) for i in range(2)]
    out = tr.generate_images(data, num_samples=3, out_dir=str(tmp_path / "inj"), max_images=None, eps=eps)
    for i in range(2):
        with torch.inference_mode():
            preds = model.sample(x[i:i + 1], 3, eps=eps[i])[0].argmax(-1).numpy()
        for s in range(3):
            assert np.array_equal(read_png(os.path.join(out, f"sample_{i}_{s}.png")), _expected_png(preds[s]))
        assert np.array_equal(read_png(os.path.join(out, f"gt_{i}.png")), _expected_png(data.test.labels[i][..., 0]))
        assert np.array_equal(read_png(os.path.join(out, f"img_{i}.png")), _expected_png(data.test.images[i]))
    tr.generate_images(data, num_samples=3, out_dir=str(tmp_path / "own"), max_images=1)
    assert sorted(os.listdir(tmp_path / "own")) == ["gt_0.png", "img_0.png"] + [f"sample_0_{s}.png" for s in range(3)]
    with torch.inference_mode():
        own = model.sample(x[:1], 3, generator=tr.eval_generator(trainer_module.GENERATE_SALT, 0))[0].argmax(-1)
    for s in range(3):
        assert np.array_equal(read_png(str(tmp_path / "own" / f"sample_0_{s}.png")), _expected_png(own[s].numpy()))


def test_generate_images_brats_slices(tmp_path):
    """BraTS: the evaluation split's mid-depth slice of the last (flair)
    channel, the whole tumour's ground truth, and each sample's whole-tumour
    prediction (softmax > 0.5); an empty mask gives an all-zero PNG."""
    arrays = synthetic.brats_arrays((2, 2), (8, 8, 8), seed=4)
    arrays["masks_validation"][1] = 0
    data = BratsData(arrays, seed=0)
    tr = Trainer(ExperimentConfig(**TOY_BRATS), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    out = tr.generate_images(data, num_samples=2, out_dir=str(tmp_path / "png"))
    assert len(os.listdir(out)) == 2 * (2 + 2)  # the test split is empty: the validation split's 2 volumes
    for i in range(2):
        img, lbl, _ = data.get(i, "validation")
        assert np.array_equal(read_png(os.path.join(out, f"img_{i}.png")), _expected_png(img[4, ..., 3]))
        assert np.array_equal(read_png(os.path.join(out, f"gt_{i}.png")), _expected_png(lbl[4, ..., 0]))
        with torch.inference_mode():
            logits = tr.state.model.sample(torch.from_numpy(img[None]), 2, generator=tr.eval_generator(
                trainer_module.GENERATE_SALT, i), chunk=trainer_module.VOLUME_SAMPLE_CHUNK)
        wt = (torch.softmax(logits[0].float(), -1)[..., 0] > 0.5).numpy()
        for s in range(2):
            assert np.array_equal(read_png(os.path.join(out, f"sample_{i}_{s}.png")), _expected_png(wt[s, 4]))
    assert not read_png(os.path.join(out, "gt_1.png")).any()


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_eval_image_is_the_whole_fold(tmp_path, monkeypatch, chunk):
    """Above EVAL_SAMPLE_PIXELS samples x pixels PHiSeg decodes
    EVAL_SAMPLE_CHUNK samples at a time (the whole fold's noise drawn
    first): on the CPU every result of ``eval_image`` bit for bit the whole
    fold's."""
    tr = Trainer(ExperimentConfig(**TOY_PHISEG), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    x = torch.randn((1, SIZE, SIZE, 1), generator=torch.Generator().manual_seed(0))
    y_all = (torch.rand((4, SIZE, SIZE), generator=torch.Generator().manual_seed(1)) > 0.6).long()
    assert tr.sample_chunk(x, 7) is None
    monkeypatch.setattr(trainer_module, "EVAL_SAMPLE_CHUNK", chunk)
    runs = {}
    for pixels in (10 ** 9, 2 * SIZE * SIZE):
        monkeypatch.setattr(trainer_module, "EVAL_SAMPLE_PIXELS", pixels)
        runs[pixels] = tr.eval_image(x, y_all, y_all[1:2], 7, n_loss=2, index=3)
    assert tr.sample_chunk(x, 7) == chunk and tr.sample_chunk(x, 2) is None
    whole, chunked = runs.values()
    assert set(whole) == set(chunked)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k
    with torch.inference_mode():
        calls = []
        real = tr.state.model.sample
        monkeypatch.setattr(tr.state.model, "sample", lambda *a, **kw: calls.append(kw["chunk"]) or real(*a, **kw))
        tr.eval_image(x, y_all, y_all[1:2], 7)
    assert calls == [chunk]


def test_registered_chunk_rule(tmp_path):
    """The registered rule: the LIDC 100-sample fold whole, a 512x512 fold of
    16 or 100 samples one sample at a time, a volume VOLUME_SAMPLE_CHUNK."""
    tr = Trainer(ExperimentConfig(**TOY_PHISEG), device="cpu", log_dir=str(tmp_path / "port"), tensorboard=False)
    assert tr.sample_chunk(torch.zeros((1, 128, 128, 1)), 100) is None
    assert tr.sample_chunk(torch.zeros((1, 512, 512, 1)), 16) == tr.sample_chunk(torch.zeros((1, 512, 512, 1)),
                                                                                  100) == 1
    tr3 = Trainer(ExperimentConfig(**TOY_BRATS), device="cpu", log_dir=str(tmp_path / "p3"), tensorboard=False)
    assert tr3.sample_chunk(torch.zeros((1, 8, 8, 8, 4)), 16) == trainer_module.VOLUME_SAMPLE_CHUNK


def test_profiling_helpers_on_the_cpu(tmp_path):
    """``trace`` writes a JSON trace of the block; the memory helpers report
    no device memory on the CPU."""
    with profiling.trace(str(tmp_path), "step") as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert path == str(tmp_path / "step")
    files = [f for f in os.listdir(path) if f.endswith(".json")]
    assert files and "traceEvents" in json.load(open(os.path.join(path, files[0])))
    assert device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert device_memory_stats() is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step_memory_analysis(lambda a: a + 1, torch.ones(3))


_CLI_RUN = """
import sys
for name in {hidden!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from unet_zoo_tpu_torch.training.cli import eval_main, train_main
assert train_main(["exp.py", "--iterations", "2", "--device", "cpu"]) == 0
assert eval_main(["exp.py", "--checkpoint", "last", "--num-repeats", "1", "--num-samples", "2", "--device", "cpu",
                  "--generate-images"]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in {hidden!r} and sys.modules[m] is not None]
assert not bad, bad
print("CLI_DONE")
"""


def test_cli_trains_and_generates_images_without_h5py(tmp_path, monkeypatch, capsys):
    """``train`` then ``eval --generate-images`` from a LIDC pickle through
    an npy cache, where neither h5py, sklearn, PIL, cv2 nor tensorboardX
    imports (a subprocess): the cache, the checkpoints, the test sweep's npz,
    and 3 test images x (image, ground truth, 10 samples) PNGs of the
    model's shape; then ``eval`` without the flag writes no PNG."""
    monkeypatch.chdir(tmp_path)
    synthetic.make_lidc_pickle("lidc.pickle", num_cases=20, num_subjects=10, size=SIZE)
    with open("config.json", "w") as f:
        json.dump({"data_root": "lidc.pickle", "preproc_folder": "pre", "log_root": "runs"}, f)
    with open("exp.py", "w") as f:
        f.write("from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
                f"config = ExperimentConfig(**{dict(TOY_PHISEG, experiment_name='CliPng', validation_frequency=2, logging_frequency=1)!r})\n")
    proc = subprocess.run([sys.executable, "-c", _CLI_RUN.format(hidden=HIDDEN, repo=str(REPO))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "CLI_DONE" in proc.stdout, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert not os.path.exists("pre/data_lidc.hdf5") and sorted(os.listdir("pre/data_lidc_npy")) == ["test", "train",
                                                                                                    "val"]
    log_dir = Path("runs/lidc/CliPng")
    for name in ("experiment.json", "last", "validation_ckpt", "best_loss", "run.log", "metrics_validation.jsonl"):
        assert (log_dir / name).exists(), name
    n_test = cache.NpyCache("pre/data_lidc_npy")["test/images"].shape[0]
    with np.load(log_dir / "test_results.npz") as f:
        assert sorted(f) == ["dice", "ged", "ncc"] and f["dice"].shape == (1, n_test, 2)
    pngs = sorted(os.listdir(log_dir / "samples"))
    assert len(pngs) == min(n_test, 10) * (2 + 10)
    assert all(_pil(log_dir / "samples" / p).shape == (SIZE, SIZE) for p in pngs)
    shutil.rmtree(log_dir / "samples")
    assert eval_main(["exp.py", "--checkpoint", "last", "--num-repeats", "1", "--num-samples", "2",
                      "--device", "cpu"]) == 0
    assert not (log_dir / "samples").exists()
    with pytest.raises(SystemExit):
        eval_main(["--help"])
    assert "--generate-images" in capsys.readouterr().out
