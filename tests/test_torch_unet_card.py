"""The U-Net on the card: the full-width forward and train step through the
conv-chain kernel against its plain path and the CPU.

* three bf16 forwards at bs512 (filters 32/64/128/192, 2 classes, 128x128)
  launch the kernel 63 times; each batch's logits against the same model
  with every block on the chain's plain version (``plain_path``), and two
  images' against the f32 model on the CPU; a batch-2 float32 forward on
  the card (21 launches of ``conv3x3_f32_3xtf32_wgmma``) against the CPU;
* the chain's autograd Function (kernel forward, library conv gradients)
  against autograd of its plain version at the test and edge shapes;
* the bf16 train step at bs64 with device augmentation for TRAIN_STEPS
  steps: 21 launches a step, no host sync inside a step, a gradient in
  every parameter, a falling loss; PARITY_STEPS kernel-path steps each
  against the same step from the same state and draws on a plain path
  differentiated by autograd.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_unet_card.py
"""

import copy
import dataclasses

import pytest
import torch

from torch_card import (BATCH, EDGE_SHAPES, F32_RTOL, FILTERS, IMAGE, TEST_SHAPES, TRAIN_BATCH, TRAIN_GRAD_RTOL_OF_MAX,
                        TRAIN_LOSS_RTOL, UNET_LAUNCHES, chain_weights, no_host_sync, plain_chain, plain_path, rel_err,
                        train_batches)
from torch_card_checks import logits_agree
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import conv_chain

pytestmark = pytest.mark.card

FORWARD_BATCHES = 3  # forwards of the counted main-path run
TRAIN_STEPS = 30  # the counted main-path run; the loss must fall over it
PARITY_STEPS = 3  # kernel path vs plain path


def unet(dev, dtype):
    from unet_zoo_tpu_torch.models.registry import get_model

    return get_model("unet", num_classes=2, num_filters=FILTERS, dtype=dtype, device=dev,
                     generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def forwards(card):
    """The bf16 model, its inputs, its logits and the launches they took."""
    model = unet(card, torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(1)
    xs = [torch.randn((BATCH, IMAGE, IMAGE, 1), generator=gen, device=card) for _ in range(FORWARD_BATCHES)]
    torch.cuda.synchronize()
    start = conv_chain.launches
    with torch.inference_mode():
        outs = [model(x) for x in xs]
    torch.cuda.synchronize()
    return model, xs, outs, conv_chain.launches - start


def test_bf16_forward_launches_the_kernel(forwards):
    _, _, outs, launched = forwards
    assert launched == FORWARD_BATCHES * UNET_LAUNCHES, f"kernel launched {launched} times"
    for logits in outs:
        assert logits.shape == (BATCH, IMAGE, IMAGE, 2) and logits.dtype == torch.bfloat16, \
            f"logits {tuple(logits.shape)} {logits.dtype}"
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        assert logits.argmax(-1).shape == (BATCH, IMAGE, IMAGE)


@pytest.mark.parametrize("i", range(FORWARD_BATCHES))
def test_bf16_forward_matches_the_plain_path(forwards, i):
    model, xs, outs, _ = forwards
    start = conv_chain.launches
    with torch.inference_mode():
        logits_agree(outs[i], plain_path(model, xs[i]), f"bf16 forward {i} bs{BATCH}, kernel vs plain path")
    torch.cuda.synchronize()
    assert conv_chain.launches == start, "the plain path launched the kernel"


def test_forward_matches_the_f32_cpu_model(card, forwards):
    """A batch-2 float32 forward on the card (the f32 kernel) against the
    CPU's plain path, and the bf16 main path's logits of its first two
    images against that CPU model."""
    _, xs, outs, _ = forwards
    x2 = torch.randn((2, IMAGE, IMAGE, 1), generator=torch.Generator().manual_seed(2))
    m_gpu, m_cpu = unet(card, torch.float32), unet("cpu", torch.float32)
    start = conv_chain.launches
    with torch.inference_mode():
        got = m_gpu(x2.to(card)).cpu()
        want = m_cpu(x2)
        main = m_cpu(xs[0][:2].cpu())
    assert conv_chain.launches - start == UNET_LAUNCHES, f"f32 forward: {conv_chain.launches - start} launches"
    err = rel_err(got, want)
    assert err <= F32_RTOL, f"f32 forward: max|diff| {err} of max|ref|"
    logits_agree(outs[0][:2].float().cpu(), main, "bf16 main path vs f32 CPU plain, 2 images")


@pytest.mark.parametrize("shape,chans", TEST_SHAPES + EDGE_SHAPES, ids=[str(s) for s, _ in TEST_SHAPES + EDGE_SHAPES])
def test_chain_function_matches_autograd(card, shape, chans):
    """The chain's autograd Function on the card against autograd of the
    plain version, float32 with TF32 off: each input, kernel and bias
    gradient within F32_RTOL of its max|grad|."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(card).requires_grad_()
    ks, bs = chain_weights(chans, gen, card, scale=0.2 if (shape, chans) in TEST_SHAPES else None)
    leaves = [x, *(t.requires_grad_() for t in ks), *(t.requires_grad_() for t in bs)]
    g = torch.randn((*shape[:3], chans[-1][1]), generator=gen).to(card)
    before = conv_chain.launches
    out = conv_chain.fused_conv_chain(x, ks, bs)
    assert conv_chain.launches == before + len(chans), f"{shape}: {conv_chain.launches - before} launches"
    assert type(out.grad_fn).__name__.startswith("FusedConvChain"), f"grad_fn {out.grad_fn}"
    got = torch.autograd.grad((out * g).sum(), leaves)
    want = torch.autograd.grad((conv_chain.fused_conv_chain_reference(x, ks, bs) * g).sum(), leaves)
    torch.cuda.synchronize()
    names = ["x"] + [f"k{j}" for j in range(len(ks))] + [f"b{j}" for j in range(len(bs))]
    for name, a, b in zip(names, got, want):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert scale > 0 and err <= F32_RTOL * scale, f"{shape} {chans} grad {name}: {err} vs max {scale}"


@pytest.fixture(scope="module")
def step_cfg(card):
    from unet_zoo_tpu_torch.experiments import get_experiment

    return dataclasses.replace(get_experiment("unet"), dtype="bfloat16")


def test_train_step(card, step_cfg, tmp_path):
    """TRAIN_STEPS bf16 steps at bs64 with device augmentation from a fixed
    seed: 21 launches a step, a non-zero gradient in every conv weight and
    bias, no host sync inside a step, a finite loss that falls."""
    from unet_zoo_tpu_torch.training import Trainer

    xs, ys = train_batches(TRAIN_STEPS, card)
    trainer = Trainer(step_cfg, card, seed=0, log_dir=str(tmp_path))
    params = dict(trainer.state.model.named_parameters())
    torch.cuda.synchronize()
    start = conv_chain.launches
    losses = [trainer.train_step(xs[0], ys[0])["loss"]]
    torch.cuda.synchronize()
    assert conv_chain.launches - start == UNET_LAUNCHES, f"first train step launched {conv_chain.launches - start}"
    dead = [n for n, p in params.items() if p.grad is None or not bool(p.grad.ne(0).any())]
    assert not dead, f"no gradient in {dead}"
    with no_host_sync():
        for i in range(1, TRAIN_STEPS):
            losses.append(trainer.train_step(xs[i], ys[i])["loss"])
    torch.cuda.synchronize()
    launched = conv_chain.launches - start
    assert launched == TRAIN_STEPS * UNET_LAUNCHES, f"{TRAIN_STEPS} train steps launched {launched}"
    losses = torch.stack(losses).float().cpu()
    assert bool(torch.isfinite(losses).all()), f"non-finite loss: {losses.tolist()}"
    tail = losses[-5:].mean().item()
    assert tail < losses[0].item(), f"loss did not fall: {losses[0]:.4f} -> {tail:.4f}"


def test_kernel_path_against_the_plain_path(card, step_cfg, tmp_path):
    """Each of PARITY_STEPS kernel-path steps against the same step on a
    plain path from the same state (the kernel path's) and draws. Step 1
    holds the loss and every gradient, so the Function's backward, against
    the plain version and its autograd. Later steps hold the loss against
    the kernel's own rounding: along two separate trajectories the losses
    from step 2 on read chance, since step-1 gradients that differ by 1-2%
    of max|grad| give Adam's first update, lr * sign(g), other signs
    wherever a gradient is near 0 (PERF.md). The plain side reads the f32
    parameters, never the kernel's packed copies, so packed weights left one
    step stale would move the kernel's loss alone; one update must move the
    loss by more than twice the gate for the gate to see that."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.training import Trainer

    xs, ys = train_batches(PARITY_STEPS, card)
    kern, plain = (Trainer(step_cfg, card, seed=1, log_dir=str(tmp_path)) for _ in range(2))
    aug_gen = torch.Generator(device=card).manual_seed(4)
    for i in range(PARITY_STEPS):
        if i:  # a copy: the optimizer would keep the live moment tensors
            plain.state.load_state_dict(copy.deepcopy(kern.state.state_dict()))
        draws = sample_augment_params(aug_gen, TRAIN_BATCH, (IMAGE, IMAGE), step_cfg.augmentation_options, card)
        lk = kern.train_step(xs[i], ys[i], draws)["loss"].item()
        with plain_chain(kernel_rounding=i > 0):
            lp = plain.train_step(xs[i], ys[i], draws)["loss"].item()
        assert abs(lk - lp) / abs(lp) <= TRAIN_LOSS_RTOL, f"step {i + 1} loss: kernel {lk} vs plain {lp}"
        if i == 0:
            for (name, pk), pp in zip(kern.state.model.named_parameters(), plain.state.model.parameters()):
                err = rel_err(pk.grad.float(), pp.grad.float())
                assert err <= TRAIN_GRAD_RTOL_OF_MAX, f"step 1 grad {name}: max|diff| {err:.3e} of max|grad|"
    with torch.no_grad():
        moved = abs(kern.forward_loss(*kern.augment(xs[i], ys[i], draws))[0].item() - lk) / lk
    assert moved > 2 * TRAIN_LOSS_RTOL, f"one update moves the loss by only {moved:.2e}"
