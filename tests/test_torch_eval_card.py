"""Evaluation and the harness on the card.

* GED, variance-NCC (both layouts) and Dice on the card against the CPU on
  the same inputs at the evaluation's shape (100 samples, 4 annotators,
  128x128; 2 classes and 3, empty masks among them): intersections exact,
  Dice equal, GED within GED_RTOL of max(1, |ref|), NCC within NCC_ATOL;
* the 100-sample evaluation of one image by the bf16 ``phiseg_7_5_12``: no
  conv-chain launch, finite GED, NCC in [-1, 1], Dice in [0, 1];
* the harness on in-memory synthetic LIDC for the bf16 ``unet`` and
  ``phiseg_7_5_12`` (``torch_card.harness``): ``train`` with validations,
  a validation that issues no host sync while it enqueues and leaves the
  train state bit-identical, for the U-Net the validation path with the
  kernel against the chain's plain version (``unet_eval_agrees``), two test
  sweeps that write the same ``test_results.npz``.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eval_card.py
"""

import pytest
import torch

from torch_card import EVAL_ANNOTATORS, EVAL_SAMPLES, NCC_ATOL, PHISEG_EXPERIMENT, metric_inputs
from torch_card_checks import eval_image_checks, harness, metrics_agree
from torch_card_checks import card  # noqa: F401  (the fixture)

pytestmark = pytest.mark.card


@pytest.mark.parametrize("n_classes", [2, 3])
def test_metrics_match_cpu(card, n_classes):
    from unet_zoo_tpu_torch import metrics as M

    logits, y_all = metric_inputs(n_classes, EVAL_SAMPLES, seed=n_classes)
    probs = torch.softmax(logits, dim=-1)
    labels = logits.argmax(-1)
    gt = torch.nn.functional.one_hot(y_all, n_classes).float()
    stacked = torch.cat([labels, y_all])
    label_range = range(1, n_classes)
    for lbl in label_range:
        (ic, sc), (ig, sg) = (M.pairwise_intersections(t, lbl) for t in (stacked, stacked.to(card)))
        assert torch.equal(ig.cpu(), ic) and torch.equal(sg.cpu(), sc), \
            f"label {lbl}: intersections differ by up to {(ig.cpu() - ic).abs().max().item()}"
    runs = {}
    for d in ("cpu", card):
        runs[d] = {
            "ged": M.generalised_energy_distance(labels.to(d), y_all.to(d), n_classes - 1, label_range),
            "ncc": M.variance_ncc_dist_class_first(probs.movedim(-1, 0).to(d), gt.movedim(-1, 0).to(d)),
            "ncc_last": M.variance_ncc_dist(probs.to(d), gt.to(d)),
            "dice": torch.stack([M.dice_per_label(labels[i].to(d), y_all[a].to(d), n_classes)
                                 for i in (0, 2, 3) for a in range(EVAL_ANNOTATORS)]),
        }
    metrics_agree(runs[card], runs["cpu"], f"metrics card vs CPU, {n_classes} classes")
    err = abs(runs[card]["ncc_last"].item() - runs["cpu"]["ncc_last"].item())
    assert err <= NCC_ATOL, f"channels-last NCC |diff| {err}"


def test_phiseg_evaluation(card, tmp_path):
    eval_image_checks(card, str(tmp_path), PHISEG_EXPERIMENT)


@pytest.mark.parametrize("name", ["unet", PHISEG_EXPERIMENT])
def test_harness(card, tmp_path, name):
    harness(card, str(tmp_path), name)
