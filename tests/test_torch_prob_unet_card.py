"""The Probabilistic U-Net (``prob_unet``: a 7-level BN-free trunk whose 13
blocks launch the conv-chain kernel 39 times a forward, two BN encoders,
``latent_dim`` 6) on the card. Its trunk blocks against the plain version
are in ``tests/test_torch_kernel_card.py``.

* the float32 model at batch 2 on the card against the CPU, same weights
  and z noise, TF32 off: eval mode (every output and each gradient tensor)
  and train mode (outputs, loss terms, the whole gradient, running
  statistics), 39 launches a forward;
* MODE_STEPS bf16 steps at bs12 of ``prob_unet`` (39 launches a step) and
  ``prob_unet_reversible`` (none): no host sync, a finite falling loss,
  ``last_conv``'s gradient an exact zero and its change Adam's decay-only
  update, each BN-followed bias of the encoders and fcomb carrying the
  regularizer's term alone;
* the registered float32 step (39 launches of the float32 kernel) and the
  float32 ``unet`` step at bs12 (21), with TF32 off and cuDNN timing its
  first two algorithms a shape, and none launched with the trunk on cuDNN;
* ``eval_image`` of one image with 100 samples (78 launches), and of the
  untrained reversible model (whose eval-mode outputs overflow);
* ``train``/``validate``/``test`` on synthetic LIDC (validated after 4
  steps: a few more make an early validation's KL NaN, in the JAX package
  as in the port).

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prob_unet_card.py
"""

import contextlib
import dataclasses
import re

import pytest
import torch

from torch_card import (ADAM_OF_LR, IMAGE, PARITY_BATCH, PHISEG_EVAL_OF_MAX, PHISEG_LOSS_RTOL, PHISEG_STATS_RTOL,
                        PHISEG_TRAIN_GRAD_L2, PHISEG_TRAIN_OF_MAX, PROB_BATCH, PROB_EVAL_TENSOR_L2, PROB_LAUNCHES,
                        REG_GRAD_RTOL, UNET_LAUNCHES, flat_rel_l2, plain_chain, rel_err, stats_err, train_batches)
from torch_card_checks import eval_image_checks, harness, mode_slice
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

PROB_EXPERIMENT = "prob_unet"
PROB_REV_EXPERIMENT = "prob_unet_reversible"
# the harness's train() for ProbUNet: a few steps and one validation. Its
# BN-free trunk's features outgrow the running statistics that eval-mode
# BatchNorm in the posterior net and fcomb uses, so sigma and the logits
# overflow and a validation's KL is NaN after 8 free f32 steps at batch 2,
# in the JAX package as in the port (CPU,
# tests/test_torch_prob_unet_validation.py), and after 20 bf16 steps at
# bs12 on the card (an NVIDIA H100 80GB HBM3 at 700 W)
PROB_HARNESS_ITERATIONS = 4
F32_ROUTE = "conv3x3_f32_3xtf32_wgmma"


def prob_run(model, x, y, eps, train: bool):
    """One ProbUNet forward with the mask, the loss and its gradients:
    (outputs, aux, {parameter: grad})."""
    model.train(train)
    model.zero_grad(set_to_none=True)
    out = model(x, y, post_eps=eps)
    loss, aux = model.loss(out, y)
    loss.backward()
    return out, aux, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_f32_card_matches_cpu(card, train):
    """The float32 model at full width, the same weights and z noise on the
    card (its trunk on the f32 kernel) and on the CPU (the plain chain)."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    cfg = get_experiment(PROB_EXPERIMENT)
    models = {d: get_model(cfg.model, **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", card)}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((PARITY_BATCH, IMAGE, IMAGE, 1), generator=gen)
    y = (torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4) > 0)[:, 0].long()
    eps = torch.randn((PARITY_BATCH, cfg.latent_dim), generator=gen)
    models[card].load_state_dict(models["cpu"].state_dict())  # the same running statistics
    out_c, aux_c, g_c = prob_run(models["cpu"], x, y, eps, train)
    torch.cuda.synchronize()
    start = conv_chain.launches
    out_g, aux_g, g_g = prob_run(models[card], x.to(card), y.to(card), eps.to(card), train)
    torch.cuda.synchronize()
    mode = "train" if train else "eval"
    assert conv_chain.launches - start == PROB_LAUNCHES, f"f32 {mode}: {conv_chain.launches - start} launches"
    of_max = PHISEG_TRAIN_OF_MAX if train else PHISEG_EVAL_OF_MAX
    for key, ref in out_c.items():
        err = rel_err(out_g[key], ref)
        assert err <= of_max, f"prob_unet f32 {mode} {key}: {err:.3e} of max|ref| > {of_max}"
    loss_err = max(abs(aux_g[k].item() - aux_c[k].item()) / abs(aux_c[k].item()) for k in ("loss", "kl", "recon"))
    assert loss_err <= PHISEG_LOSS_RTOL, f"prob_unet f32 {mode} loss terms: rel diff {loss_err:.3e}"
    zero = [n for n in ("last_conv.conv.weight", "last_conv.conv.bias") if g_c[n].any() or g_g[n].any()]
    assert not zero, f"prob_unet f32 {mode}: a non-zero last_conv gradient in {zero}"
    l2 = flat_rel_l2(g_g, g_c)
    assert l2 <= PHISEG_TRAIN_GRAD_L2, f"prob_unet f32 {mode} gradient: rel L2 {l2:.3e}"
    if train:
        err = stats_err(models[card], models["cpu"])
        assert err <= PHISEG_STATS_RTOL, f"prob_unet running statistics: rel diff {err:.3e}"
    else:
        tensor_l2, worst = max((((g_g[n].cpu() - g_c[n]).norm() / g_c[n].norm()).item(), n)
                               for n in g_c if g_c[n].any())
        assert tensor_l2 <= PROB_EVAL_TENSOR_L2, f"prob_unet f32 eval gradient {worst}: rel L2 {tensor_l2:.3e}"


def prob_grad_gates(model, before: dict, cfg, label: str) -> None:
    """The first step's gradients and update: every parameter has a
    gradient; each bias that BatchNorm follows (a conv bias beside a ``bn``,
    a coupling function's ``_bias``) has exactly the regularizer's term (the
    encoders' and fcomb's) or an exact zero (the trunk's); ``last_conv``'s
    gradient is an exact zero and its change is coupled-L2 Adam's first
    update of the decay alone, -lr * g / (|g| + 1e-8) with g = wd * p; every
    other gradient is non-zero."""
    from unet_zoo_tpu_torch.models.prob_unet import NORM_EPS, REG_WEIGHT

    lr, wd = cfg.learning_rate, cfg.weight_decay
    params = dict(model.named_parameters())
    missing = [n for n, p in params.items() if p.grad is None]
    assert not missing, f"{label}: no gradient in {missing}"
    reg = {n for n, _ in model.regularized_parameters()}
    cut = [n for n in params if re.search(r"block\d+_[fg]_bias$", n)
           or (n.endswith("conv.bias") and f"{n[:-len('conv.bias')]}bn.weight" in params)]
    for n in cut:
        if n in reg:
            b = before[n]
            want = REG_WEIGHT * b / torch.sqrt(b.square().sum() + NORM_EPS)
            err = ((params[n].grad - want).abs().max() / want.abs().max()).item()
            assert err <= REG_GRAD_RTOL, f"{label}: {n}'s gradient {err:.3e} off the regularizer's term"
        else:
            assert not params[n].grad.any(), f"{label}: a non-zero gradient in {n}, which BatchNorm follows"
    adam_err = 0.0
    for n in ("last_conv.conv.weight", "last_conv.conv.bias"):
        assert not params[n].grad.any(), f"{label}: a non-zero gradient in {n}"
        g = wd * before[n]
        adam_err = max(adam_err, (params[n].detach() - before[n] + lr * g / (g.abs() + 1e-8)).abs().max().item())
    assert adam_err <= ADAM_OF_LR * lr, f"{label}: last_conv moved {adam_err:.3e} off Adam's decay-only update"
    dead = [n for n in params if n not in cut and not n.startswith("last_conv.") and not params[n].grad.any()]
    assert not dead, f"{label}: all-zero gradient in {dead}"


@pytest.mark.parametrize("name,launches", [(PROB_EXPERIMENT, PROB_LAUNCHES), (PROB_REV_EXPERIMENT, 0)])
def test_bf16_steps(card, tmp_path, name, launches):
    mode_slice(card, str(tmp_path), name, launches=launches, gates=prob_grad_gates)


@pytest.mark.parametrize("experiment,launches,batch", [(PROB_EXPERIMENT, PROB_LAUNCHES, None),
                                                       ("unet", UNET_LAUNCHES, PROB_BATCH)])
def test_registered_f32_step(card, tmp_path, experiment, launches, batch):
    """A registered float32 step on the f32 kernel, as ``Trainer`` sets it
    up; in turns (kernel, cuDNN, cuDNN, kernel) with every trunk block on
    the chain's plain version, whose convs are cuDNN's, in place of the
    kernel's wrapper: the kernel steps launch ``launches`` each, the cuDNN
    steps none."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment(experiment)
    assert cfg.dtype == "float32", f"{experiment} is registered in {cfg.dtype}"
    cfg = dataclasses.replace(cfg, batch_size=batch or cfg.batch_size)
    xs, ys = train_batches(1, card, cfg.batch_size)
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path))
    assert trainer.chain_route == F32_ROUTE, f"f32 chains route to {trainer.chain_route}"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, \
        "Trainer left TF32 on for a float32 experiment"
    assert torch.backends.cudnn.benchmark and torch.backends.cudnn.benchmark_limit == 2, \
        "Trainer left cuDNN on its instant heuristic, not timing its first two algorithms a shape"
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    start = conv_chain.launches
    trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    launched = conv_chain.launches - start
    assert launched == launches, f"f32 {experiment} step: {launched} launches of {F32_ROUTE}"
    for route in ("kernel", "cudnn", "cudnn", "kernel"):
        with plain_chain() if route == "cudnn" else contextlib.nullcontext():
            trainer.train_step(xs[0], ys[0])
    torch.cuda.synchronize()
    assert conv_chain.launches == start + 3 * launches, \
        f"f32 turns: {conv_chain.launches - start} launches, expected the kernel's steps only"


@pytest.mark.parametrize("name,launches,finite", [(PROB_EXPERIMENT, 2 * PROB_LAUNCHES, True),
                                                  (PROB_REV_EXPERIMENT, 0, False)])
def test_evaluation(card, tmp_path, name, launches, finite):
    """Untrained, the reversible trunk's he_normal coupling blocks grow their
    input ~1e10-fold on BatchNorm's initial running statistics (eval mode),
    so sigma overflows and the eval-mode loss is NaN, as the JAX model's is
    (its features reach 1.3e10 at init, float32 on a CPU), and the saturated
    samples make NCC's entropy map constant, so NaN."""
    eval_image_checks(card, str(tmp_path), name, launches=launches, finite=finite)


def test_harness(card, tmp_path):
    harness(card, str(tmp_path), PROB_EXPERIMENT, iterations=PROB_HARNESS_ITERATIONS,
            frequency=PROB_HARNESS_ITERATIONS)
