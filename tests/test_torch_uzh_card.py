"""The UZH prostate path (``phiseg_uzh_7_5_512``: PHiSeg 2D at filters
32/64/128/192/192/192/192, 5 latent levels, 3 classes, 6 annotators,
512x512, batch 12) on the card.

* the registered architecture at 192x192 (``phiseg_uzh_7_5_192`` and
  ``phiseg_uzh_rev_7_5_192``), batch 2, float32 with TF32 off, the same
  weights and z noise on the card and the CPU, train and eval mode;
* ``UZHProstateData`` over ``synthetic.uzh_arrays`` at 512x512, whose
  registry ``resize_to`` (a zoom at factor 1) leaves the batches as they
  were; UZH_STEPS registered steps (f32, the 3-label device augmentation): a
  gradient in every parameter (an exact zero in each bias that BatchNorm
  follows), no host sync inside a step, running statistics that move, a
  finite loss, no conv-chain launch;
* batch 12 fits the card in plain, remat and reversible mode with cuDNN's
  TF32 off and on, and in bf16;
* ``validate`` over more validation images than ``EVAL_IMAGE_WINDOW`` (one
  enqueue a window, no host sync while it enqueues) and ``test``;
* ``UZHMatData`` over a ``scipy.io.savemat`` file of 160 slices at 192x192;
* ``eval_image`` of one 512x512 image at 100 samples decoded in chunks, and
  at 16 samples the chunked evaluation against the whole fold.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_uzh_card.py
"""

import dataclasses
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from torch_card import F32_RTOL, NCC_ATOL, deterministic, no_host_sync
from torch_card_checks import no_sync_enqueue, phiseg_parity, zero_bias_gates
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

UZH_EXPERIMENT = "phiseg_uzh_7_5_512"
UZH_REV_EXPERIMENT = "phiseg_uzh_rev_7_5_512"
UZH_PARITY = ("phiseg_uzh_7_5_192", "phiseg_uzh_rev_7_5_192")  # at the smallest registered resolution
UZH_STEPS = 2  # the counted run of the registered step
UZH_SPLITS = (12, 9, 2)  # synthetic train / validation / test slices; validation > EVAL_IMAGE_WINDOW
UZH_SAMPLES = 16  # the registered validation_samples
UZH_MAT_SLICES, UZH_MAT_SIZE = 160, 192  # 10 train, 100 validation, 50 test
CHUNK_SAMPLES = (100, 16)  # the fitting fold, and the fold compared whole and chunked
# (experiment, TF32, changes) of each step that must fit the card at batch 12
VARIANTS = [(name, tf32, changes) for tf32 in (False, True)
            for name, changes in ((UZH_EXPERIMENT, {}), (UZH_EXPERIMENT, {"reversible_mode": "remat"}),
                                  (UZH_REV_EXPERIMENT, {}))] + [(UZH_EXPERIMENT, False, {"dtype": "bfloat16"})]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", UZH_PARITY)
def test_f32_card_matches_cpu(card, name, train):
    from unet_zoo_tpu_torch.experiments import get_experiment

    phiseg_parity(card, name, train, size=get_experiment(name).image_size[0])


@pytest.fixture(scope="module")
def uzh(card, tmp_path_factory):
    """The registered trainer after UZH_STEPS steps on synthetic 512x512
    slices: (trainer, data, host batches, the losses, the launches, the
    running statistics before the steps)."""
    from unet_zoo_tpu_torch.data import UZHProstateData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment(UZH_EXPERIMENT)
    data = UZHProstateData(synthetic.uzh_arrays(UZH_SPLITS, cfg.image_size[0], seed=0), seed=0)
    host_batches = [data.train.next_batch(cfg.batch_size) for _ in range(UZH_STEPS)]
    xs = [torch.from_numpy(x).to(card) for x, _ in host_batches]
    ys = [torch.from_numpy(y).to(card) for _, y in host_batches]
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path_factory.mktemp("uzh")))
    stats0 = {n: b.clone() for n, b in trainer.state.model.named_buffers()}
    start = conv_chain.launches
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    zero_bias_gates(trainer.state.model, cfg, f"{UZH_EXPERIMENT} f32")
    with no_host_sync():
        for i in range(1, UZH_STEPS):
            losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.synchronize()
    yield trainer, data, host_batches, torch.stack(losses).float().cpu(), conv_chain.launches - start, stats0
    trainer.close()


def test_data(uzh):
    """``from_config`` builds the providers without ``resize_to``; the
    registry's, a scipy zoom at factor 1, must leave a batch as it was."""
    from unet_zoo_tpu_torch.data import UZHProstateData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment

    _, _, host_batches, _, _, _ = uzh
    cfg = get_experiment(UZH_EXPERIMENT)
    zoomed = UZHProstateData(synthetic.uzh_arrays(UZH_SPLITS, cfg.image_size[0], seed=0), resize_to=cfg.resize_to,
                             seed=0).train
    assert all(np.array_equal(a, b) for xy in host_batches for a, b in zip(xy, zoomed.next_batch(cfg.batch_size))), \
        "resize_to at factor 1 changed a batch"
    assert set(np.unique(np.concatenate([y for _, y in host_batches])).tolist()) == {0, 1, 2}, "the batches lack a class"


def test_registered_steps(uzh):
    trainer, _, _, losses, launches, stats0 = uzh
    assert launches == 0, f"the UZH step launched the kernel {launches} times"
    same = [n for n, b in trainer.state.model.named_buffers() if torch.equal(b, stats0[n])]
    assert not same, f"running statistics that did not change: {same}"
    assert bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}"


@pytest.mark.parametrize("experiment,tf32,changes", VARIANTS,
                         ids=[f"{e}-tf32_{t}-{'-'.join(c.values()) or 'registered'}" for e, t, c in VARIANTS])
def test_batch_fits(card, uzh, tmp_path, experiment, tf32, changes):
    """A warm-up step and one more at batch 12 in each memory mode and dtype:
    an out-of-memory step fails."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    _, _, host_batches, _, _, _ = uzh
    x, y = (torch.from_numpy(a).to(card) for a in host_batches[0])
    torch.cuda.empty_cache()
    try:
        trainer = Trainer(dataclasses.replace(get_experiment(experiment), **changes), card, seed=0,
                          log_dir=str(tmp_path), tensorboard=False, tf32=tf32)
        losses = [trainer.train_step(x, y)["loss"] for _ in range(2)]
        torch.cuda.synchronize()
        trainer.close()
    finally:  # the Trainer sets both flags as tf32 says
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert all(bool(torch.isfinite(v)) for v in losses), f"non-finite loss {losses}"


def test_validate_and_test(uzh):
    """``validate`` over "all" validation images (16 samples, 6 annotators,
    3 classes), one enqueue a window, with no host sync while it enqueues;
    ``test`` with 1 repeat."""
    from unet_zoo_tpu_torch.training.trainer import EVAL_IMAGE_WINDOW

    trainer, data, _, _, _, _ = uzh
    n_val, n_test = data.validation.images.shape[0], data.test.images.shape[0]
    assert n_val > EVAL_IMAGE_WINDOW, f"{n_val} validation images, not more than a window ({EVAL_IMAGE_WINDOW})"
    windows, enqueue = [], trainer.evaluate_images
    with mock.patch.object(trainer, "evaluate_images", lambda *a, **k: (windows.append(1), enqueue(*a, **k))[1]), \
            no_sync_enqueue(trainer):
        agg = trainer.validate(data)
    assert math.isfinite(agg["ged"]) and -1.0 <= agg["ncc"] <= 1.0 and 0.0 <= agg["dice"] <= 1.0 \
        and all(math.isfinite(agg[k]) for k in ("loss", "kl", "recon")), f"UZH validation {agg}"
    assert len(windows) == -(-n_val // EVAL_IMAGE_WINDOW), f"{len(windows)} windows for {n_val} images"
    trainer.test(data, num_repeats=1, num_samples=UZH_SAMPLES, checkpoint="best_loss")
    with np.load(os.path.join(trainer.log_dir, "test_results.npz")) as f:
        shapes = {k: f[k].shape for k in f.files}
    assert shapes == {"ged": (1, n_test), "ncc": (1, n_test), "dice": (1, n_test, trainer.cfg.n_classes)}, \
        f"test_results.npz {shapes}"


def test_mat_data(card, tmp_path):
    """``UZHMatData`` over a ``.mat`` written by ``scipy.io.savemat``: the
    10/100/50 split, the batches' shapes and dtypes, one train step (batch
    2 of the 10 train slices) of ``phiseg_uzh_7_5_192``."""
    import scipy.io

    from unet_zoo_tpu_torch.data import UZHMatData, synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    arrays = synthetic.uzh_arrays((UZH_MAT_SLICES, 0, 0), UZH_MAT_SIZE, seed=1)
    path = str(tmp_path / "uzh.mat")
    scipy.io.savemat(path, {"images": arrays["images_train"], "labels": arrays["masks_train"]})
    data = UZHMatData(path, seed=0)
    sizes = [len(getattr(data, s).indices) for s in ("train", "validation", "test")]
    assert sizes == [10, 100, 50], f"UZHMatData splits {sizes}"
    for split in ("train", "validation", "test"):
        x, y = getattr(data, split).next_batch(2)
        assert x.shape == (2, UZH_MAT_SIZE, UZH_MAT_SIZE, 1) and x.dtype == np.float32 \
            and y.shape == (2, UZH_MAT_SIZE, UZH_MAT_SIZE) and y.dtype == np.int32 and int(y.max()) <= 2, \
            f"UZHMatData {split} batch {x.shape} {x.dtype} {y.shape} {y.dtype}"
    trainer = Trainer(get_experiment(UZH_PARITY[0]), card, seed=0, log_dir=str(tmp_path / "log"), tensorboard=False)
    x, y = data.train.next_batch(2)
    loss = trainer.train_step(trainer._to_device(x), trainer._to_device(y))["loss"]
    assert bool(torch.isfinite(loss)) and trainer.state.step == 1, f"UZHMatData step: loss {loss.item()}"
    trainer.close()


def test_chunked_evaluation(card, tmp_path):
    """``eval_image`` of one ``phiseg_uzh_7_5_512`` image at 100 samples
    (decoded ``sample_chunk`` at a time), and at 16 samples the chunked
    evaluation and its logits against the whole fold's (cuDNN deterministic
    on both). cuDNN takes other float32 algorithms for a batch of 1 than of
    16, so the logits round apart (the CPU test holds them bit for bit): the
    logits within F32_RTOL, NCC within NCC_ATOL, every other result equal."""
    from unet_zoo_tpu_torch.data import synthetic
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer
    from unet_zoo_tpu_torch.training import trainer as trainer_module

    cfg = get_experiment(UZH_EXPERIMENT)
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path))
    arrays = synthetic.uzh_arrays((1, 1, 1), cfg.image_size[0], seed=0)
    x = torch.from_numpy(arrays["images_test"][:1])[..., None].to(card)
    labels = torch.from_numpy(np.moveaxis(arrays["masks_test"][:1], -1, 1).copy()).long().to(card)
    y_all, y_chosen = labels[0], labels[0, :1]
    n_big, n_cmp = CHUNK_SAMPLES
    out = trainer.eval_image(x, y_all, y_chosen, n_big)
    assert math.isfinite(out["ged"].item()) and -1 <= out["ncc"].item() <= 1 and \
        bool(((out["dice"] >= 0) & (out["dice"] <= 1)).all()), f"100-sample evaluation {out}"
    chunk = trainer.sample_chunk(x, n_cmp)
    with deterministic():
        chunked = trainer.eval_image(x, y_all, y_chosen, n_cmp)
        with mock.patch.object(trainer_module, "EVAL_SAMPLE_PIXELS", 1 << 62):
            whole = trainer.eval_image(x, y_all, y_chosen, n_cmp)
        with torch.inference_mode():
            logits_chunked, logits_whole = (
                trainer.state.model.sample(x, n_cmp, generator=torch.Generator(device=card).manual_seed(5), chunk=c)
                for c in (chunk, None))
        logit_err = (logits_chunked - logits_whole).abs().max().item()
        logit_tol = F32_RTOL * logits_whole.abs().max().item()
    ncc_err = (whole["ncc"] - chunked["ncc"]).abs().item()
    differ = [k for k in whole if k != "ncc" and not torch.equal(whole[k], chunked[k])]
    assert chunk is not None and not differ and ncc_err <= NCC_ATOL and logit_err <= logit_tol, \
        f"chunked vs whole fold at {n_cmp} samples: {differ} differ, NCC by {ncc_err:.3e}, logits by " \
        f"{logit_err:.3e} (tol {logit_tol:.3e}; chunk {chunk})"
    trainer.close()
