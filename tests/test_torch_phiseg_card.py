"""PHiSeg 2D (``phiseg_7_5_12``) on the card: float32 against the CPU, the
bf16 train step and the float32 evaluation of one image.

* the float32 model at batch 2 with the mask, the loss and every gradient
  on the card against the same weights and z noise on the CPU (TF32 off),
  in train mode (the whole gradient and the running statistics) and eval
  mode (each gradient tensor);
* PHISEG_STEPS bf16 steps at bs12 with device augmentation: no host sync
  inside a step, a gradient in every parameter (an exact zero in each conv
  bias that BatchNorm follows, which Adam's weight decay still moves),
  running statistics that change, a falling loss, no conv-chain launch; then
  ``sample(x, 100)``;
* the float32 evaluation of one image with 16 samples on the card against
  the CPU on the same weights and noise: the logits, the metrics of the
  CPU's logits on both sides, and the eval-mode loss.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phiseg_card.py
"""

import dataclasses

import pytest
import torch

from torch_card import (EVAL_SAMPLES, IMAGE, PHISEG_EVAL_OF_MAX, PHISEG_EXPERIMENT, PHISEG_LOSS_RTOL, metric_inputs,
                        no_host_sync, rel_err, train_batches)
from torch_card_checks import metrics_agree, phiseg_parity
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

PHISEG_STEPS = 30  # the loss must fall over them
EVAL_PARITY_SAMPLES = 16


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_f32_card_matches_cpu(card, train):
    phiseg_parity(card, PHISEG_EXPERIMENT, train)


def test_bf16_train_step(card, tmp_path):
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = dataclasses.replace(get_experiment(PHISEG_EXPERIMENT), dtype="bfloat16")
    xs, ys = train_batches(PHISEG_STEPS, card, cfg.batch_size)
    trainer = Trainer(cfg, card, seed=0, log_dir=str(tmp_path))
    model = trainer.state.model
    params = dict(model.named_parameters())
    heads = {f"likelihood.head{j}.conv.bias" for j in range(cfg.latent_levels)}
    free = [n for n in params if n.endswith("conv.bias") and n not in heads]
    before = {n: params[n].detach().clone() for n in free}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    start = conv_chain.launches
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    missing = [n for n, p in params.items() if p.grad is None]
    assert not missing, f"no gradient in {missing}"
    nonzero = [n for n in free if bool(params[n].grad.ne(0).any())]
    assert not nonzero, f"conv biases before BatchNorm with a non-zero gradient: {nonzero}"
    still = [n for n in free if torch.equal(params[n].detach(), before[n])]
    assert not still, f"conv biases before BatchNorm that Adam did not move: {still}"
    dead = [n for n in params if n not in free and not bool(params[n].grad.ne(0).any())]
    assert not dead, f"all-zero gradient in {dead}"
    with no_host_sync():
        for i in range(1, PHISEG_STEPS):
            losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.synchronize()
    assert conv_chain.launches == start, f"the PHiSeg step launched the kernel {conv_chain.launches - start} times"
    same = [n for n, b in model.named_buffers() if torch.equal(b, stats0[n])]
    assert not same, f"running statistics that did not change: {same}"
    losses = torch.stack(losses).float().cpu()
    assert bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}"
    assert losses[-5:].mean().item() < losses[0].item(), f"loss did not fall: {losses.tolist()}"

    with torch.inference_mode():
        samples = model.sample(xs[0][:1], EVAL_SAMPLES)
    assert samples.shape == (1, EVAL_SAMPLES, IMAGE, IMAGE, cfg.n_classes) and samples.dtype == torch.bfloat16, \
        f"samples {tuple(samples.shape)} {samples.dtype}"
    assert bool(torch.isfinite(samples).all()), "non-finite samples"
    assert samples.float().std(dim=1).mean().item() > 0, "the samples are all the same"


def test_f32_evaluation_matches_cpu(card, tmp_path):
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer, image_metrics

    cfg = get_experiment(PHISEG_EXPERIMENT)
    trainers = {d: Trainer(cfg, d, seed=5, log_dir=str(tmp_path)) for d in ("cpu", card)}
    n = EVAL_PARITY_SAMPLES
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((1, IMAGE, IMAGE, 1), generator=gen)
    _, y_all = metric_inputs(cfg.n_classes, 1, seed=9)
    shapes = [(IMAGE >> (lvl + 2),) * 2 + (cfg.zdim,) for lvl in range(cfg.latent_levels)]
    eps = [torch.randn((1, n, *s), generator=gen) for s in shapes]
    loss_eps = tuple([torch.randn((1, *s), generator=gen) for s in shapes] for _ in range(2))
    logits, outs = {}, {}
    for d, tr in trainers.items():
        with torch.inference_mode():
            logits[d] = tr.state.model.sample(x.to(d), n, eps=[e.to(d) for e in eps])[0].cpu()
        outs[d] = tr.eval_image(x.to(d), y_all.to(d), y_all[:1].to(d), n, eps=[e.to(d) for e in eps],
                                loss_eps=tuple([e.to(d) for e in le] for le in loss_eps))
    err = rel_err(logits[card], logits["cpu"])
    assert err <= PHISEG_EVAL_OF_MAX, f"f32 eval logits: {err:.3e} of max|ref|"
    ref = image_metrics(logits["cpu"], y_all, y_all[0])
    metrics_agree(image_metrics(logits["cpu"].to(card), y_all.to(card), y_all[0].to(card)), ref,
                  f"f32 {PHISEG_EXPERIMENT} metrics of the CPU's logits, card vs CPU")
    loss_err = max(abs(outs[card][k].item() - outs["cpu"][k].item()) / abs(outs["cpu"][k].item())
                   for k in ("loss", "kl", "recon"))
    assert loss_err <= PHISEG_LOSS_RTOL, f"f32 eval-mode loss terms: rel diff {loss_err:.3e}"
