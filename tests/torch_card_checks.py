"""The ``card`` fixture and the checks that several card modules
(``tests/test_torch_*_card.py``) share: each an assertion body over the
shapes and gates of ``tests/torch_card.py``. Imports torch, pytest and the
port only, never JAX; the tools import none of it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from torch_card import (BF16_FORWARD_ULPS, BF16_ULPS, D_RTOL, EVAL_ANNOTATORS, EVAL_SAMPLES, F32_3XTF32_RTOL, F32_RTOL,
                        GED_RTOL, HARNESS_ITERATIONS, HARNESS_LAUNCHES, HARNESS_SPLITS, HARNESS_TEST_REPEATS,
                        HARNESS_TEST_SAMPLES, HARNESS_VALIDATION_FREQUENCY, HARNESS_VALIDATION_SAMPLES, IMAGE,
                        MODE_STEPS, NCC_ATOL, PARITY_BATCH, PHISEG_EVAL_GRAD_OF_MAX, PHISEG_EVAL_OF_MAX,
                        PHISEG_LOSS_RTOL, PHISEG_STATS_RTOL, PHISEG_TRAIN_GRAD_L2, PHISEG_TRAIN_OF_MAX, REPEATS,
                        UNET_LAUNCHES, bf16_ulp, flat_rel_l2, lidc_data, no_host_sync, plain_chain, rel_err,
                        same_state, stats_err, train_batches, z_eps)
from unet_zoo_tpu_torch.ops.pallas import conv_chain


@pytest.fixture(scope="module")
def card():
    """The card, with cuDNN's and the matmuls' TF32 off (strict float32, as
    ``Trainer`` sets it); skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    torch.cuda.empty_cache()


def compare(x, ks, bs, label: str) -> None:
    """The kernel against its plain version on the same CUDA tensors: f32
    within F32_RTOL of max|plain| (and within F32_3XTF32_RTOL of the kernel's
    own 3xTF32 arithmetic in plain PyTorch), bf16 within BF16_ULPS ulps."""
    out = conv_chain.fused_conv_chain(x, ks, bs)
    ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype, f"{label}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}"
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert scale > 0, f"{label}: plain output is all zero"
    tol = F32_RTOL * scale if x.dtype == torch.float32 else BF16_ULPS * bf16_ulp(scale)
    if x.dtype == torch.float32:
        e_err = (out - conv_chain.fused_conv_chain_3xtf32(x, ks, bs)).abs().max().item()
        assert e_err <= F32_3XTF32_RTOL * scale, f"{label}: {e_err} from the 3xTF32 plain version"
    assert err <= tol, f"{label}: max|diff| {err} > tol {tol}"


def repeats_differ(x, ks, bs) -> int:
    """Launches of REPEATS on the same inputs that differ from a first one."""
    packed = [conv_chain.pack_kernel(k, x.dtype) for k in ks]
    first = conv_chain.fused_conv_chain(x, ks, bs, packed=packed)
    return sum(not torch.equal(conv_chain.fused_conv_chain(x, ks, bs, packed=packed), first) for _ in range(REPEATS))


def logits_agree(got, want, label: str) -> None:
    """bf16 main-path logits (B, H, W, 2) against reference logits."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = BF16_FORWARD_ULPS * bf16_ulp(want.abs().max().item())
    d_got, d_want = got[..., 1] - got[..., 0], want[..., 1] - want[..., 0]
    worst = ((d_got - d_want) ** 2).mean(dim=(1, 2)).sqrt().max().item() / d_want.std().item()
    assert err <= tol, f"{label}: max|diff| {err} > {tol}"
    assert worst <= D_RTOL, f"{label}: logit difference off by {worst} of its spread"


def no_sync_enqueue(trainer):
    """Patches ``trainer.evaluate_images``, the per-image enqueue loop of
    ``validate`` and ``test``, so that a host sync inside it raises."""
    enqueue = trainer.evaluate_images

    def guarded(*args, **kwargs):
        torch.cuda.synchronize()
        with no_host_sync():
            return enqueue(*args, **kwargs)

    return mock.patch.object(trainer, "evaluate_images", guarded)


def phiseg_run(model, x, y, post_eps, prior_eps, train: bool):
    """One forward with the mask, the loss and its gradients, in train or
    eval mode: (outputs, aux, {parameter: grad})."""
    model.train(train)
    model.zero_grad(set_to_none=True)
    out = model(x, y, post_eps=post_eps, prior_eps=prior_eps)
    loss, aux = model.loss(out, y)
    loss.backward()
    return out, aux, {n: p.grad for n, p in model.named_parameters()}


def phiseg_outputs_agree(runs: dict, dev, train: bool, label: str) -> None:
    """PHiSeg's (PHiSeg3D's) card run against the CPU's (``phiseg_run``
    results): outputs, loss terms and gradients at the f32 gates of ``train``
    mode; running statistics are the caller's."""
    (out_c, aux_c, g_c), (out_g, aux_g, g_g) = runs["cpu"], runs[dev]
    of_max = PHISEG_TRAIN_OF_MAX if train else PHISEG_EVAL_OF_MAX
    for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma"):
        for lvl, (a, b) in enumerate(zip(out_g[key], out_c[key])):
            err = rel_err(a, b)
            assert err <= of_max, f"{label} {key}[{lvl}]: {err:.3e} of max|ref| > {of_max}"
    for key in ("loss", "kl", "recon"):
        err = abs(aux_g[key].item() - aux_c[key].item()) / abs(aux_c[key].item())
        assert err <= PHISEG_LOSS_RTOL, f"{label} {key}: rel diff {err:.3e} > {PHISEG_LOSS_RTOL}"
    missing = [n for n in g_c if g_c[n] is None or g_g[n] is None]
    assert not missing, f"{label}: no gradient in {missing}"


def phiseg_parity(dev, experiment: str, train: bool, size: int = IMAGE) -> None:
    """Float32 ``experiment`` (PHiSeg 2D) at ``size`` x ``size``, batch 2,
    the same weights and z noise on the card and the CPU (TF32 off), with
    labels of every class of the experiment, in train or eval mode: in train
    mode the whole gradient and the running statistics, in eval mode (both
    sides on the running statistics of one train-mode forward) each gradient
    tensor."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.models.registry import get_model

    cfg = dataclasses.replace(get_experiment(experiment), image_size=(size, size))
    models = {d: get_model("phiseg", **cfg.model_kwargs(), device=d, generator=torch.Generator().manual_seed(5))
              for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((PARITY_BATCH, size, size, 1), generator=gen)
    smooth = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 9, 1, 4)[:, 0]
    y = sum((smooth > 0.1 * c).long() for c in range(cfg.n_classes - 1))  # smooth is ~N(0, 0.11^2)
    first = len(cfg.filter_channels) - cfg.latent_levels
    eps = {kind: [torch.randn((PARITY_BATCH, size >> (lvl + first), size >> (lvl + first), cfg.zdim), generator=gen)
                  for lvl in range(cfg.latent_levels)] for kind in ("post", "prior")}
    if not train:  # the same running statistics on both sides, moved by a train-mode forward
        with torch.no_grad():
            models["cpu"].train()(x, y, post_eps=eps["post"], prior_eps=eps["prior"])
        models[dev].load_state_dict(models["cpu"].state_dict())
    runs = {}
    for d, m in models.items():
        runs[d] = phiseg_run(m, x.to(d), y.to(d), [e.to(d) for e in eps["post"]], [e.to(d) for e in eps["prior"]],
                             train)
    label = f"{experiment} f32 {'train' if train else 'eval'}"
    phiseg_outputs_agree(runs, dev, train, label)
    g_c, g_g = runs["cpu"][2], runs[dev][2]
    if train:
        l2 = flat_rel_l2(g_g, g_c)
        assert l2 <= PHISEG_TRAIN_GRAD_L2, f"{label} gradient: rel L2 {l2:.3e} > {PHISEG_TRAIN_GRAD_L2}"
        err = stats_err(models[dev], models["cpu"])
        assert err <= PHISEG_STATS_RTOL, f"{label} running statistics: rel diff {err:.3e}"
    else:
        per_tensor, worst = max((rel_err(g_g[n], g_c[n]), n) for n in g_c if g_c[n].any())
        assert per_tensor <= PHISEG_EVAL_GRAD_OF_MAX, f"{label} gradient {worst}: {per_tensor:.3e} of max|g|"


def zero_bias_gates(model, cfg, label: str) -> None:
    """The first step's gradients: every parameter has one; each bias that
    BatchNorm follows (a coupling function's ``_bias``, a conv bias beside a
    ``bn``) an exact zero, every other a non-zero one."""
    params = dict(model.named_parameters())
    free = [n for n in params if n.endswith("_bias")
            or (n.endswith("conv.bias") and f"{n[:-len('conv.bias')]}bn.weight" in params)]
    missing = [n for n, p in params.items() if p.grad is None]
    assert not missing, f"{label}: no gradient in {missing}"
    nonzero = [n for n in free if bool(params[n].grad.ne(0).any())]
    assert not nonzero, f"{label}: biases that BatchNorm follows with a non-zero gradient: {nonzero}"
    dead = [n for n in params if n not in free and not bool(params[n].grad.ne(0).any())]
    assert not dead, f"{label}: all-zero gradient in {dead}"


def stats_fold_once(trainer, x, y, gen, dev) -> float:
    """One train step from given draws, against a no-grad train-mode forward
    of a copy of the model from the state before it, on the same augmented
    batch and z noise: that forward folds each batch statistic into the
    running ones once, so the step's running statistics must equal it (a
    second fold in the backward's re-run would move them by ~1% of a
    statistic). Every statistic must move. Returns max|diff| over the
    buffer's max|value|."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params

    cfg, model = trainer.cfg, trainer.state.model
    draws = sample_augment_params(gen, x.shape[0], (IMAGE, IMAGE), cfg.augmentation_options, dev)
    latent = cfg.model in ("phiseg", "prob_unet")
    eps = z_eps(cfg, x.shape[0], gen, dev) if latent else None
    before = copy.deepcopy(model)
    trainer.train_step(x, y, draws, eps)
    got, want = dict(model.named_buffers()), dict(before.named_buffers())
    still = [n for n, b in want.items() if torch.equal(got[n], b)]
    assert got and not still, f"{cfg.experiment_name}: running statistics that did not move: {still}"
    xa, ya = trainer.augment(x, y, draws)
    with torch.no_grad():
        before.train()
        before(xa, ya, post_eps=eps) if latent else before(xa)
    return max(rel_err(got[n], b) for n, b in want.items())


def mode_slice(dev, log_dir: str, name: str, batch=None, mode=None, launches=None, gates=None) -> None:
    """MODE_STEPS bf16 steps of one path from a fixed seed, at ``batch`` and
    in memory mode ``mode`` (the registered ones by default): the first
    step's gradients held by ``gates(model, parameters before, cfg, label)``
    (``zero_bias_gates`` by default), no host sync in the others,
    ``launches`` conv-chain launches a step (where given), finite losses
    that fall, the running statistics folded once a step."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16")
    if batch is not None:
        cfg = dataclasses.replace(cfg, batch_size=batch)
    if mode is not None:
        cfg = dataclasses.replace(cfg, reversible_mode=mode)
    label = f"{name} {cfg.effective_reversible_mode} bs{cfg.batch_size} bf16"
    xs, ys = train_batches(MODE_STEPS, dev, cfg.batch_size)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    model = trainer.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    start = conv_chain.launches
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    first = conv_chain.launches - start
    assert launches is None or first == launches, f"{label}: step 1 launched {first}, expected {launches}"
    if gates is None:
        zero_bias_gates(model, cfg, label)
    else:
        gates(model, before, cfg, label)
    del before
    with no_host_sync():
        for i in range(1, MODE_STEPS):
            losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.synchronize()
    launched = conv_chain.launches - start
    assert launches is None or launched == MODE_STEPS * launches, f"{label}: {launched} launches in {MODE_STEPS} steps"
    losses = torch.stack(losses).float().cpu()
    assert bool(torch.isfinite(losses).all()), f"{label}: non-finite loss {losses.tolist()}"
    assert losses[-3:].mean().item() < losses[0].item(), f"{label}: loss did not fall: {losses.tolist()}"
    if list(model.buffers()):
        err = stats_fold_once(trainer, xs[0], ys[0], torch.Generator(device=dev).manual_seed(12), dev)
        assert err <= 1e-6, f"{label}: running statistics {err:.3e} off one fold a step"
    trainer.close()


def eval_image_checks(dev, log_dir: str, experiment: str, launches: int = 0, finite: bool = True) -> None:
    """The EVAL_SAMPLES-sample evaluation of one image by bf16 ``experiment``:
    ``launches`` conv-chain launches, finite GED and loss, NCC in [-1, 1],
    Dice in [0, 1]. Without ``finite`` (a model whose eval-mode outputs
    overflow) the loss and NCC may be NaN."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(experiment), dtype="bfloat16")
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((1, IMAGE, IMAGE, 1), generator=gen, device=dev)
    y_all = torch.randint(0, cfg.n_classes, (EVAL_ANNOTATORS, IMAGE, IMAGE), generator=gen, device=dev)
    torch.cuda.synchronize()
    start = conv_chain.launches
    out = trainer.eval_image(x, y_all, y_all[:1], EVAL_SAMPLES)
    torch.cuda.synchronize()
    launched = conv_chain.launches - start
    assert launched == launches, f"the {experiment} evaluation launched {launched}, expected {launches}"
    ged, ncc, dice = out["ged"].item(), out["ncc"].item(), out["dice"].cpu()
    assert math.isfinite(ged) and (math.isfinite(out["loss"].item()) or not finite), \
        f"GED {ged}, loss {out['loss'].item()}"
    assert -1.0 <= ncc <= 1.0 or (math.isnan(ncc) and not finite), f"NCC {ncc} outside [-1, 1]"
    assert bool(((dice >= 0) & (dice <= 1)).all()), f"Dice {dice.tolist()} outside [0, 1]"
    trainer.close()


def ncc_moves(got, want, y_all) -> torch.Tensor:
    """How far each image's variance-NCC may move when its U-Net logits
    (B, H, W, C) move from ``want`` to ``got`` (the samples all agree, so
    one sample gives the maps): NCC is the mean over the annotators of the
    correlation of the E_ss and E_sy maps, and by Cauchy-Schwarz a
    correlation moves by at most 2|da|/|a - mean a| for each map ``a`` that
    moves by ``da``."""
    def maps(logits):
        p = torch.softmax(logits.float(), -1)
        log_p = torch.log(p + 1e-8)
        e_ss = -(p * log_p).sum(-1)
        e_sy = -torch.gather(log_p[:, None].expand(-1, y_all.shape[1], -1, -1, -1), -1, y_all[..., None])[..., 0]
        return e_ss, e_sy  # (B, H, W), (B, A, H, W)

    def moves(a, b):
        return 2 * (a - b).flatten(-2).norm(dim=-1) / (b - b.mean((-2, -1), keepdim=True)).flatten(-2).norm(dim=-1)

    (g_ss, g_sy), (w_ss, w_sy) = maps(got), maps(want)
    return (moves(g_ss, w_ss)[:, None] + moves(g_sy, w_sy)).mean(1)


def unet_eval_agrees(trainer, data, n_val: int) -> None:
    """The U-Net's validation path (batch-1 forwards, full width, 21 launches
    an image) with the kernel against the chain's plain version on the same
    trained weights, images and annotator picks: the logits by
    ``logits_agree`` with no argmax flip; then ``evaluate_images``' rows:
    Dice and GED of the same labels equal, NCC within what the logits'
    difference can move it (``ncc_moves``) plus NCC_ATOL (NaN where the
    plain path's is NaN), the loss terms within twice the logits' max|diff|
    (softmax CE moves by at most that) plus f32 rounding."""
    from unet_zoo_tpu_torch.training.trainer import EVAL_SCALARS

    images, labels = trainer._upload(data.validation, 0, n_val)
    val_rng, annotators = trainer._eval_rng(), trainer._annotators()
    chosen = [int(val_rng.choice(annotators)) for _ in range(n_val)]
    model = trainer.state.model
    runs = {}
    for path in ("kernel", "plain"):
        torch.cuda.synchronize()
        before = conv_chain.launches
        with plain_chain() if path == "plain" else contextlib.nullcontext():
            was_training = model.training
            model.eval()
            with torch.inference_mode():
                logits = torch.cat([model.sample(images[i:i + 1], 1)[:, 0] for i in range(n_val)])
            model.train(was_training)
            rows, _ = trainer.evaluate_images(images, labels, chosen, HARNESS_VALIDATION_SAMPLES,
                                              HARNESS_VALIDATION_SAMPLES, salt=0)
        torch.cuda.synchronize()
        runs[path] = (logits.float().cpu(), rows.cpu(), conv_chain.launches - before)
    (got, got_rows, launched), (want, want_rows, plain_launched) = runs["kernel"], runs["plain"]
    expected = 2 * n_val * UNET_LAUNCHES
    assert launched == expected and plain_launched == 0, \
        f"unet validation path: {launched} launches with the kernel (expected {expected}), {plain_launched} plain"
    logits_agree(got, want, f"unet validation path, {n_val} trained-model forwards at batch 1, kernel vs plain")
    err = (got - want).abs().max().item()
    flips = int((got.argmax(-1) != want.argmax(-1)).sum().item())
    assert flips == 0, f"unet validation path: {flips} argmax flips between the kernel and the plain chain"
    k = len(EVAL_SCALARS)
    col = {name: i for i, name in enumerate(EVAL_SCALARS)}
    ged_err = (got_rows[:, col["ged"]] - want_rows[:, col["ged"]]).abs().max().item()
    assert ged_err <= GED_RTOL * max(1.0, want_rows[:, col["ged"]].abs().max().item()), f"GED |diff| {ged_err}"
    g_ncc, w_ncc = got_rows[:, col["ncc"]], want_rows[:, col["ncc"]]
    assert torch.equal(g_ncc.isnan(), w_ncc.isnan()), f"NCC NaN pattern {g_ncc.tolist()} vs {w_ncc.tolist()}"
    finite = ~w_ncc.isnan()
    ncc_diff, ncc_tol = (g_ncc - w_ncc).abs()[finite], (ncc_moves(got, want, labels.cpu()) + NCC_ATOL)[finite]
    assert bool((ncc_diff <= ncc_tol).all()), f"NCC |diff| {ncc_diff.tolist()} > tol {ncc_tol.tolist()}"
    assert torch.equal(got_rows[:, k:], want_rows[:, k:]), f"Dice {got_rows[:, k:]} vs {want_rows[:, k:]}"
    terms = [col[t] for t in ("loss", "kl", "recon")]
    loss_err = (got_rows[:, terms] - want_rows[:, terms]).abs().max().item()
    loss_tol = 2 * err + 1e-6 * max(1.0, want_rows[:, terms].abs().max().item())
    assert loss_err <= loss_tol, f"loss terms |diff| {loss_err} > {loss_tol}"


def metrics_agree(got: dict, want: dict, label: str) -> None:
    """GED within GED_RTOL of max(1, |ref|), NCC within NCC_ATOL, Dice equal."""
    ged_tol = GED_RTOL * max(1.0, abs(want["ged"].item()))
    assert abs(got["ged"].item() - want["ged"].item()) <= ged_tol, f"{label}: GED {got['ged']} vs {want['ged']}"
    assert abs(got["ncc"].item() - want["ncc"].item()) <= NCC_ATOL, f"{label}: NCC {got['ncc']} vs {want['ncc']}"
    assert torch.equal(got["dice"].cpu(), want["dice"].cpu()), f"{label}: Dice {got['dice']} vs {want['dice']}"


def harness(dev, log_dir: str, name: str, iterations: int = HARNESS_ITERATIONS,
            frequency: int = HARNESS_VALIDATION_FREQUENCY) -> None:
    """bf16 ``name`` on in-memory synthetic LIDC: ``train`` for
    ``iterations`` with a validation every ``frequency`` (launches, metrics
    records, checkpoint files), one more validation that issues no host sync
    while it enqueues and leaves the train state bit-identical, for the U-Net
    ``unet_eval_agrees``, and two test sweeps that write the same
    ``test_results.npz``."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    data = lidc_data()
    n_val, n_test = HARNESS_SPLITS[1], HARNESS_SPLITS[2]
    validations = iterations // frequency
    cfg = dataclasses.replace(get_experiment(name), dtype="bfloat16", validation_frequency=frequency,
                              logging_frequency=frequency, num_validation_images=n_val,
                              validation_samples=HARNESS_VALIDATION_SAMPLES)
    trainer = Trainer(cfg, dev, seed=0, log_dir=log_dir)
    unet = cfg.model == "unet"
    per_step, per_image = HARNESS_LAUNCHES[cfg.model]
    torch.cuda.synchronize()
    start = conv_chain.launches
    aux = trainer.train(data, iterations=iterations)
    torch.cuda.synchronize()
    expected = iterations * per_step + validations * n_val * per_image
    assert conv_chain.launches - start == expected, f"{name}: train() launched {conv_chain.launches - start}, " \
                                                    f"expected {expected}"
    assert trainer.state.step == iterations and math.isfinite(aux["loss"].item()), \
        f"{name}: step {trainer.state.step}, loss {aux['loss'].item()}"
    with open(os.path.join(log_dir, "metrics_validation.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [frequency * (i + 1) for i in range(validations)], \
        f"{name}: validation records {records}"
    # NCC is NaN where an image's E_ss is constant (the U-Net's samples
    # all agree, and a saturated output has a constant entropy); NaN is
    # never a best, as in the JAX package, so best_ncc needs a finite one
    files = ["validation_ckpt", "best_dice", "best_loss", "best_ged", "best_metrics.json",
             "metrics_validation.jsonl", "metrics_train.jsonl"]
    files += ["best_ncc"] if any(math.isfinite(r["ncc"]) for r in records) else []
    missing = [f for f in files if not os.path.exists(os.path.join(log_dir, f))]
    assert not missing, f"{name}: missing {missing}"

    before = copy.deepcopy(trainer.state.state_dict())
    torch.cuda.synchronize()
    start = conv_chain.launches
    with no_sync_enqueue(trainer):
        agg = trainer.validate(data)
    torch.cuda.synchronize()
    assert conv_chain.launches - start == n_val * per_image, \
        f"{name}: validate() launched {conv_chain.launches - start}, expected {n_val * per_image}"
    same_state(before, trainer.state.state_dict())
    del before
    ncc_ok = -1 <= agg["ncc"] <= 1 or (unet and math.isnan(agg["ncc"]))
    assert all(math.isfinite(agg[k]) for k in ("ged", "loss")) and ncc_ok and 0 <= agg["dice"] <= 1, \
        f"{name}: validation {agg}"
    if unet:
        unet_eval_agrees(trainer, data, n_val)

    runs = []
    for _ in range(2):
        with no_sync_enqueue(trainer):
            trainer.test(data, num_repeats=HARNESS_TEST_REPEATS, num_samples=HARNESS_TEST_SAMPLES,
                         checkpoint="best_loss")
        with np.load(os.path.join(log_dir, "test_results.npz")) as f:
            runs.append({k: f[k] for k in f.files})
    shapes = {k: v.shape for k, v in runs[0].items()}
    assert shapes == {"ged": (HARNESS_TEST_REPEATS, n_test), "ncc": (HARNESS_TEST_REPEATS, n_test),
                      "dice": (HARNESS_TEST_REPEATS, n_test, cfg.n_classes)}, f"{name}: test_results {shapes}"
    assert all(np.array_equal(runs[0][k], runs[1][k], equal_nan=True) for k in runs[0]), \
        f"{name}: two test sweeps differ"
    trainer.close()
