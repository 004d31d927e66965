"""PHiSeg3D and the BraTS path (``phiseg_brats``: filters 32/64/128, 2 latent
levels, 128^3x4, 3 one-hot WT/TC/ET classes, reversible with one coupling
block a sequence) on the card, which launches no hand-written kernel.

* a BN-free 3D conv sequence raises on the card;
* the architecture at PARITY_SIZE, batch 1, float32 with TF32 off, plain and
  reversible: the same weights and z noise on the card and the CPU, eval
  mode (outputs, loss terms, each gradient tensor) and train mode (outputs,
  loss terms, the whole gradient, running statistics);
* the registered step (float32, reversible, 128^3, batch 1, 3D augmentation
  with the elastic field) for BRATS_STEPS steps: a gradient in every
  parameter (an exact zero in each bias that BatchNorm follows), no host
  sync inside a step, running statistics that move, a finite loss; one
  step each of the registered, the plain and the bf16 trainer;
* ``sample(x, 16)`` decoded in chunks of ``VOLUME_SAMPLE_CHUNK`` against the
  whole fold from the same noise; ``validate`` (``validate_brats``) with its
  checkpoints, ``test`` (``test_brats``, the npz schema) and
  ``export_predictions``, whose ``.nii.gz`` files read back in the original
  geometry with labels in {0, 1, 2, 4}.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_brats_card.py
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from torch_card import (F32_RTOL, IMAGE, PHISEG_STATS_RTOL, PHISEG_TRAIN_GRAD_L2, PROB_EVAL_TENSOR_L2, flat_rel_l2,
                        no_host_sync, stats_err)
from torch_card_checks import phiseg_outputs_agree, phiseg_run, zero_bias_gates
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

BRATS_EXPERIMENT = "phiseg_brats"
PARITY_SIZE = (32, 32, 32)  # the card against the CPU at a cut volume
BRATS_STEPS = 3
BRATS_VAL_VOLUMES = 2
BRATS_SAMPLES = 16  # the registered validation_samples


def brats_volumes(size, n_train: int, n_val: int):
    """Synthetic BraTS arrays (``data.synthetic.brats_arrays``, crop offsets
    included) from a fixed seed, and the train volumes as batches of one
    with their one-hot WT/TC/ET labels."""
    from unet_zoo_tpu_torch.data import synthetic
    from unet_zoo_tpu_torch.data.brats import to_evaluation_onehot

    arrays = synthetic.brats_arrays((n_train, n_val), size, seed=0, keep_offsets=True)
    xs = [torch.from_numpy(arrays["images_train"][i:i + 1]) for i in range(n_train)]
    ys = [torch.from_numpy(to_evaluation_onehot(arrays["masks_train"][i:i + 1])) for i in range(n_train)]
    return arrays, xs, ys


def test_bn_free_3d_sequence_raises(card):
    from unet_zoo_tpu_torch import ops

    seq = ops.ConvSeq(4, 8, 2, ndim=3, device=card)
    with pytest.raises(NotImplementedError):
        seq(torch.zeros((1, 4, 4, 4, 4), device=card))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", ["plain", "reversible"])
def test_f32_card_matches_cpu(card, mode, train):
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    _, xs, ys = brats_volumes(PARITY_SIZE, 1, 0)
    x, y = xs[0], ys[0]
    cfg = dataclasses.replace(get_experiment(BRATS_EXPERIMENT), image_size=PARITY_SIZE, reversible_mode=mode)
    models = {d: get_model(cfg.model, **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", card)}
    gen = torch.Generator().manual_seed(6)
    eps = {kind: [torch.randn((1, *[s >> (lvl + 1) for s in PARITY_SIZE], cfg.zdim), generator=gen)
                  for lvl in range(cfg.latent_levels)] for kind in ("post", "prior")}
    models[card].load_state_dict(models["cpu"].state_dict())  # the same running statistics
    runs = {"cpu": phiseg_run(models["cpu"], x, y, eps["post"], eps["prior"], train)}
    torch.cuda.synchronize()
    start = conv_chain.launches
    runs[card] = phiseg_run(models[card], x.to(card), y.to(card), [e.to(card) for e in eps["post"]],
                            [e.to(card) for e in eps["prior"]], train)
    torch.cuda.synchronize()
    assert conv_chain.launches == start, f"PHiSeg3D launched the kernel {conv_chain.launches - start} times"
    label = f"PHiSeg3D {mode} f32 {'train' if train else 'eval'}"
    phiseg_outputs_agree(runs, card, train, label)
    g_c, g_g = runs["cpu"][2], runs[card][2]
    l2 = flat_rel_l2(g_g, g_c)
    assert l2 <= PHISEG_TRAIN_GRAD_L2, f"{label} gradient: rel L2 {l2:.3e}"
    if train:
        err = stats_err(models[card], models["cpu"])
        assert err <= PHISEG_STATS_RTOL, f"{label} running statistics: rel diff {err:.3e}"
    else:
        tensor_l2, worst = max((((g_g[n].cpu() - g_c[n]).norm() / g_c[n].norm()).item(), n)
                               for n in g_c if g_c[n].any())
        assert tensor_l2 <= PROB_EVAL_TENSOR_L2, f"{label} gradient {worst}: rel L2 {tensor_l2:.3e}"


@pytest.fixture(scope="module")
def registered(card, tmp_path_factory):
    """The registered trainer after BRATS_STEPS steps on synthetic volumes:
    (trainer, arrays, the device batches, the losses, the launches, the
    running statistics before the steps)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    arrays, xs, ys = brats_volumes((IMAGE,) * 3, BRATS_STEPS, BRATS_VAL_VOLUMES)
    xs, ys = [t.to(card) for t in xs], [t.to(card) for t in ys]
    cfg = get_experiment(BRATS_EXPERIMENT)
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path_factory.mktemp("brats")))
    stats0 = {n: b.clone() for n, b in trainer.state.model.named_buffers()}
    torch.cuda.synchronize()
    start = conv_chain.launches
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    zero_bias_gates(trainer.state.model, cfg, f"{BRATS_EXPERIMENT} f32")
    with no_host_sync():
        for i in range(1, BRATS_STEPS):
            losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.synchronize()
    yield trainer, arrays, xs, ys, torch.stack(losses).float().cpu(), conv_chain.launches - start, stats0
    trainer.close()


def test_registered_steps(registered):
    trainer, _, _, _, losses, launches, stats0 = registered
    assert launches == 0, f"the PHiSeg3D step launched the kernel {launches} times"
    same = [n for n, b in trainer.state.model.named_buffers() if torch.equal(b, stats0[n])]
    assert not same, f"running statistics that did not change: {same}"
    assert bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}"


@pytest.mark.parametrize("changes", [{}, {"reversible_mode": "plain"}, {"dtype": "bfloat16"}],
                         ids=["registered", "plain", "bf16"])
def test_step_variant(card, registered, tmp_path, changes):
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    _, _, xs, ys, _, _, _ = registered
    trainer = Trainer(dataclasses.replace(get_experiment(BRATS_EXPERIMENT), **changes), card, seed=0,
                      log_dir=str(tmp_path), tensorboard=False)
    loss = trainer.train_step(xs[0], ys[0])["loss"]
    assert bool(torch.isfinite(loss)), f"{changes}: non-finite loss {loss.item()}"
    trainer.close()


def test_chunked_sample_matches_the_whole_fold(card, registered):
    from unet_zoo_tpu_torch.training.trainer import VOLUME_SAMPLE_CHUNK

    trainer, _, xs, _, _, _, _ = registered
    model = trainer.state.model
    with torch.inference_mode():
        whole, chunked = (model.sample(xs[0], BRATS_SAMPLES, generator=torch.Generator(device=card).manual_seed(5),
                                       chunk=chunk) for chunk in (None, VOLUME_SAMPLE_CHUNK))
    err = (chunked - whole).abs().max().item()
    assert err <= F32_RTOL * whole.abs().max().item(), f"chunked sample {err:.3e} from the whole fold"


def test_validate_test_and_export(registered):
    from unet_zoo_tpu_torch.data import BratsData
    from unet_zoo_tpu_torch.utils import load_nii

    trainer, arrays, _, _, _, _, _ = registered
    log_dir = trainer.log_dir
    data = BratsData(arrays, seed=0)
    agg = trainer.validate(data)
    assert all(math.isfinite(agg[k]) for k in ("loss", "kl", "recon")), f"non-finite validation loss: {agg}"
    assert all(0.0 <= agg[f"dice_{r}"] <= 1.0 for r in ("wt", "tc", "et")), f"validation Dice outside [0, 1]: {agg}"
    for name in ("validation_ckpt", "best_dice", "best_loss"):
        assert os.path.exists(os.path.join(log_dir, name)), f"no {name} after validate_brats"
    trainer.test(data, num_repeats=1, num_samples=BRATS_SAMPLES, checkpoint="best_loss")
    with np.load(os.path.join(log_dir, "brats_test_results.npz")) as f:
        assert all(f[k].shape == (1, BRATS_VAL_VOLUMES, 3) for k in ("dice", "sensitivity", "specificity", "hd95")), \
            f"brats_test_results.npz: {dict((k, f[k].shape) for k in f.files)}"
    paths = trainer.export_predictions(data, num_samples=BRATS_SAMPLES)
    assert len(paths) == BRATS_VAL_VOLUMES, f"exported {len(paths)} files"
    for ii, path in enumerate(paths):
        vol = load_nii(path)[0]
        orig = tuple(int(s) for s in arrays["origShape_validation"][ii])
        assert vol.shape == orig and vol.dtype == np.uint8 and set(np.unique(vol).tolist()) <= {0, 1, 2, 4}, \
            f"{path}: {vol.shape} {vol.dtype} labels {np.unique(vol).tolist()}, want {orig}"
