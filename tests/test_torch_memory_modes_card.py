"""The remat and reversible memory modes on the card.

* ``ReversibleChain`` against autograd of the same coupling chain at the
  full-width block shapes, each gradient's distance from the float64 one
  against autograd's, in float32 with TF32 off and in bf16;
* a batch-2 float32 ``phiseg_rev_7_5_12`` in train mode on the card against
  the CPU, at PHiSeg's train-mode gates;
* MODE_STEPS bf16 steps each of ``phiseg_rev_7_5_12`` and
  ``reversible_unet`` at bs12 and the remat ``unet`` at bs64: no host sync
  inside a step, an exact zero gradient in each bias that BatchNorm
  follows, running statistics folded once a step, a falling loss, 42
  conv-chain launches a remat U-Net step (21 in the backward's re-run) and
  none on the reversible paths;
* the remat U-Net step bit-identical to the plain one from the same state
  and draws (cuDNN deterministic, the resize as matrix products);
* the first bf16 RevPHiSeg step against its f32 twin, each side's
  parameter change equal to coupled-L2 Adam's first update written out
  from its own gradient;
* PHiSeg's float32 step at bs12 peaks lower in remat and reversible mode
  than in plain, with cuDNN's TF32 off and on (``torch_card.step_peak``, the
  peak that ``tools/torch_memory.py`` tabulates);
* the 100-sample evaluation of one image by the bf16 RevPHiSeg.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_memory_modes_card.py
"""

import dataclasses
import math

import pytest
import torch

from torch_card import (ADAM_OF_LR, IMAGE, MEMORY_MODES, REV_BF16_VS_AUTOGRAD, REV_F32_VS_AUTOGRAD, REV_STEP_GRAD_L2,
                        TRAIN_BATCH, UNET_LAUNCHES, deterministic, step_peak, train_batches, z_eps)
from torch_card_checks import eval_image_checks, mode_slice, phiseg_parity
from torch_card_checks import card  # noqa: F401  (the fixture)

pytestmark = pytest.mark.card

REV_EXPERIMENT = "phiseg_rev_7_5_12"
# the reversible blocks at full width: 192 channels at 8x8 (PHiSeg's coarse
# levels) and 64 at 128x128 (the widest tensor a coupling function sees),
# batch 12, 3 coupling blocks (a PHiSeg down block)
REV_BLOCK_SHAPES = [(12, 8, 8, 192), (12, 128, 128, 64)]
REV_DEPTH = 3
# (experiment, batch, memory mode, launches a step) of the bf16 paths
PATHS = [(REV_EXPERIMENT, 12, None, 0), ("reversible_unet", 12, None, 0), ("unet", TRAIN_BATCH, "remat",
                                                                           2 * UNET_LAUNCHES)]


@pytest.mark.parametrize("shape", REV_BLOCK_SHAPES, ids=str)
def test_reversible_chain_matches_autograd(card, shape):
    from unet_zoo_tpu_torch.ops import reversible as rev

    def function(x, ps):
        return rev.ReversibleChain.apply(x, None, *ps)[0]

    def autograd(x, ps):
        return rev.coupling_chain(x, rev._blocks(ps))[0]

    def rel_l2(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    c = shape[-1]
    seq = rev.ReversibleSequence(c, c, REV_DEPTH, device=card, generator=torch.Generator().manual_seed(9)).train()
    gen = torch.Generator(device=card).manual_seed(10)
    x, g = (torch.randn(shape, generator=gen, device=card) for _ in range(2))
    names = ["x"] + [n for n, _ in seq.named_parameters()]

    def grads(fn, dtype):
        xx = x.to(dtype).requires_grad_()
        ps = [p.detach().to(torch.float64 if dtype == torch.float64 else torch.float32).requires_grad_()
              for p in seq.parameters()]
        y = fn(xx, ps)
        return y, torch.autograd.grad(y, [xx, *ps], g.to(dtype))

    (y, got), (y_ref, want) = grads(function, torch.float32), grads(autograd, torch.float32)
    exact = grads(autograd, torch.float64)[1]
    assert torch.equal(y, y_ref), f"{shape}: the Function's f32 output differs from the chain's"
    for name, a, b, e in zip(names, got, want, exact):
        if not e.any():  # the coupling biases: an exact zero everywhere
            assert not a.any() and not b.any(), f"{shape} {name}: a non-zero gradient"
            continue
        fn_err, ag_err = rel_l2(a, e), rel_l2(b, e)
        assert fn_err <= REV_F32_VS_AUTOGRAD * ag_err + 1e-5, \
            f"{shape} f32 {name}: {fn_err:.3e} from float64, autograd's {ag_err:.3e}"
    f32, fb, ab = [torch.cat([t.float().flatten() for t in ts]) for ts in (want,) + tuple(
        grads(fn, torch.bfloat16)[1] for fn in (function, autograd))]
    fn_err, ag_err = rel_l2(fb, f32.double()), rel_l2(ab, f32.double())
    assert fn_err <= REV_BF16_VS_AUTOGRAD * ag_err + 0.01, f"{shape} bf16: {fn_err:.3e} from f32 vs {ag_err:.3e}"


def test_revphiseg_f32_card_matches_cpu(card):
    phiseg_parity(card, REV_EXPERIMENT, train=True)


@pytest.mark.parametrize("name,batch,mode,launches", PATHS, ids=[p[0] + (f"-{p[2]}" if p[2] else "") for p in PATHS])
def test_bf16_steps(card, tmp_path, name, batch, mode, launches):
    mode_slice(card, str(tmp_path), name, batch, mode, launches=launches)


def test_remat_step_matches_plain(card, tmp_path):
    """The remat U-Net step against the plain one from the same state and
    draws, with cuDNN deterministic and a deterministic resize on both
    sides: loss and every gradient bit-identical."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    base = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=TRAIN_BATCH)
    xs, ys = train_batches(1, card)
    draws = sample_augment_params(torch.Generator(device=card).manual_seed(11), TRAIN_BATCH, (IMAGE, IMAGE),
                                  base.augmentation_options, card)
    runs = {}
    with deterministic():
        for mode in ("plain", "remat"):
            tr = Trainer(dataclasses.replace(base, reversible_mode=mode), card, seed=1, log_dir=str(tmp_path))
            loss = tr.train_step(xs[0], ys[0], draws)["loss"]
            runs[mode] = (loss, {n: p.grad.clone() for n, p in tr.state.model.named_parameters()})
            del tr
    (loss_p, grads_p), (loss_r, grads_r) = runs["plain"], runs["remat"]
    assert torch.equal(loss_p, loss_r), f"remat loss {loss_r.item()} vs plain {loss_p.item()}"
    differ = [n for n in grads_p if not torch.equal(grads_p[n], grads_r[n])]
    assert not differ, f"remat gradients differ from plain in {differ}"


def test_bf16_revphiseg_step_agrees_with_f32(card, tmp_path):
    """The first bf16 ``phiseg_rev_7_5_12`` step at bs12 against the f32 step
    from the same weights, batch, augmentation draws and z noise. The loss
    and the whole gradient agree within bf16's reach, and on each side the
    parameter change equals coupled-L2 Adam's first update written out from
    that side's own gradient: ``-lr * g / (|g| + eps)`` with ``g = grad +
    weight_decay * p``. A falling loss alone cannot show that: the path's
    loss climbs thirty-fold before it falls."""
    from unet_zoo_tpu_torch.data.augment import sample_augment_params
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    batch = 12
    cfg = dataclasses.replace(get_experiment(REV_EXPERIMENT), batch_size=batch)
    xs, ys = train_batches(1, card, batch)
    gen = torch.Generator(device=card).manual_seed(13)
    draws = sample_augment_params(gen, batch, (IMAGE, IMAGE), cfg.augmentation_options, card)
    eps = z_eps(cfg, batch, gen, card)
    lr, wd = cfg.learning_rate, cfg.weight_decay
    runs = {}
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(dataclasses.replace(cfg, dtype=dtype), card, seed=0, log_dir=str(tmp_path))
        params = dict(trainer.state.model.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        loss = trainer.train_step(xs[0], ys[0], draws, eps)["loss"].float()
        grads = {n: p.grad.detach().clone() for n, p in params.items()}
        adam_err = 0.0
        for n, g in grads.items():
            g = g + wd * before[n]
            adam_err = max(adam_err, (params[n].detach() - before[n] + lr * g / (g.abs() + 1e-8)).abs().max().item())
        assert adam_err <= ADAM_OF_LR * lr, f"{dtype}: the first update is {adam_err:.3e} off Adam's"
        runs[dtype] = (loss, grads)
        del trainer, params
        torch.cuda.empty_cache()
    (l32, g32), (l16, g16) = runs["float32"], runs["bfloat16"]
    fa, fb = (torch.cat([t.double().flatten() for t in d.values()]) for d in (g16, g32))
    grad_l2 = ((fa - fb).norm() / fb.norm()).item()
    loss_rel = abs(l16.item() - l32.item()) / abs(l32.item())
    assert math.isfinite(loss_rel) and grad_l2 <= REV_STEP_GRAD_L2, \
        f"bf16 step vs f32: loss {l16.item()} vs {l32.item()}, gradient {grad_l2:.3e} relative L2"


@pytest.mark.parametrize("tf32", [False, True], ids=["tf32_off", "tf32_on"])
def test_remat_and_reversible_peak_below_plain(card, tmp_path, tf32):
    """PHiSeg's float32 step at bs12 (a cell of ``tools/torch_memory.py``): the
    remat and the reversible step's peak below the plain one's, with cuDNN's
    TF32 off and on."""
    try:
        peak = {mode: step_peak("phiseg_7_5_12", mode, 12, card, str(tmp_path), tf32)["peak_bytes"]
                for mode in MEMORY_MODES}
    finally:  # the Trainer sets both flags as tf32 says
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    assert peak["remat"] < peak["plain"] and peak["reversible"] < peak["plain"], \
        f"PHiSeg f32 bs12 peak memory (TF32 {tf32}): {peak}"


def test_revphiseg_evaluation(card, tmp_path):
    eval_image_checks(card, str(tmp_path), REV_EXPERIMENT)
