"""The port's ProbUNet against the benchmark's plain reference
(``benchmark/reference/prob_unet.py``), on the CPU at the reference's test
size (``TINY``: filters 4/8/8, 16x16; latent_dim 6 and 3 fcomb convs as
published), batch 4.

One set of weights is drawn by the benchmark (``inputs.weights``, from the
reference's ``specs()``) and loaded into the port by path
(``inputs.load_into``, which raises where the two name different leaves);
BatchNorm's running statistics are then set away from 0 and 1 so that eval
mode reads them. Given the same posterior noise, the train-mode loss terms,
every leaf's gradient and the running statistics' moves agree; ``last_conv``
takes an exact zero gradient on both sides; ``sample``'s logits agree in
eval mode.

The tolerances. Both sides compute in float32 with the same operations in
a different layout (NHWC against NCHW), so they part by float32 rounding
alone: over 21 seeds at this size, the loss terms by at most 2e-7 of
max(|term|, 1), a leaf's gradient by 3e-6 to 2e-5 of max(its norm, the
median leaf's) and by 1.4e-4 on one seed (a trunk ReLU whose input rounds
across zero), the logits by at most 1e-6 of their largest. The tolerances
are five to ten times the largest. The port with a bfloat16 forward parts
by 4e-4 to 4e-3 in the loss terms and by 0.45-0.82 in the worst leaf's
gradient: ``test_bf16_forward_fails_the_tolerances`` holds that the
tolerances see it.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import inputs, spec
from benchmark.reference import prob_unet as reference
from unet_zoo_tpu_torch.models.prob_unet import ProbUNet

CELL = "prob_unet_lidc.train_bs12"
BATCH, SAMPLES = 4, 5
SEEDS = (2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5, 2 ** 31 + 6)
# relative gaps: the loss terms against max(|term|, 1); a leaf's gradient (L2 of the difference) against
# max(its norm, the median leaf's); the logits and the running statistics against their largest magnitude
TERMS_TOL, GRAD_TOL, VALUE_TOL = 1e-6, 1e-3, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    return reference.build(spec.cell(CELL).config["experiment"], reference.TINY)


def _setup(seed, dtype=None):
    """(reference, port, parameters, buffers, x NHWC, mask, posterior noise):
    the same drawn weights in both."""
    ref = _reference()
    params, bufs = inputs.weights(ref.specs(), seed, "cpu")
    g = torch.Generator().manual_seed(seed % 1000)
    for name, t in bufs.items():
        bufs[name] = (0.75 + 0.5 * torch.rand(t.shape, generator=g) if name.endswith("running_var")
                      else 0.1 * torch.randn(t.shape, generator=g))
    port = ProbUNet(ref.C, ref.f, latent_dim=ref.latent_dim, no_convs_fcomb=ref.fcomb_depth + 1,
                    in_channels=ref.in_channels, kl_parity=True, dtype=dtype, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    inputs.load_into(port, params, bufs)
    h, w = ref.image_size
    x = torch.randn((BATCH, h, w, ref.in_channels), generator=g)
    mask = torch.randint(0, ref.C, (BATCH, h, w), generator=g)
    eps = torch.randn((BATCH, ref.latent_dim), generator=g)
    return ref, port, params, bufs, x, mask, eps


def _train_step(seed, dtype=None):
    """Both sides' train-mode loss terms, gradients by leaf and running
    statistics after the forward."""
    ref, port, params, bufs, x, mask, eps = _setup(seed, dtype)
    port.train()
    _, aux = port.loss(port(x, mask, post_eps=eps), mask)
    names = [n for n, _ in port.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(aux["loss"], list(port.parameters()))))
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    moved = {k: v.clone() for k, v in bufs.items()}
    terms = ref.step_loss(p, moved, x.permute(0, 3, 1, 2), mask, z_eps=eps, train=True)
    want = dict(zip(p, torch.autograd.grad(terms["loss"], list(p.values()))))
    return ({k: float(aux[k].detach()) for k in terms}, {k: float(terms[k].detach()) for k in terms}, got, want,
            dict(port.named_buffers()), moved)


def _gaps(step):
    """The largest relative gap of the loss terms and of a leaf's gradient."""
    got_terms, want_terms, got, want = step[:4]
    terms = max(abs(got_terms[k] - want_terms[k]) / max(abs(want_terms[k]), 1.0) for k in want_terms)
    norms = {k: float(v.norm()) for k, v in want.items()}
    median = sorted(norms.values())[len(norms) // 2]
    grads = max(float((got[k].float() - want[k]).norm()) / max(norms[k], median) for k in want)
    return terms, grads


@pytest.mark.parametrize("seed", SEEDS)
def test_train_terms_and_gradients(seed):
    step = _train_step(seed)
    _, _, got, want, got_bufs, want_bufs = step
    assert got.keys() == want.keys()
    terms, grads = _gaps(step)
    assert terms <= TERMS_TOL and grads <= GRAD_TOL, (terms, grads)
    for k in ("last_conv.conv.weight", "last_conv.conv.bias"):
        assert not got[k].any() and not want[k].any(), k
    for k, t in want_bufs.items():
        assert float((got_bufs[k] - t).abs().max()) <= VALUE_TOL * float(t.abs().max()), k


def test_sample_logits_in_eval_mode():
    ref, port, params, bufs, x, _, _ = _setup(SEEDS[0])
    eps = torch.randn((1, SAMPLES, ref.latent_dim), generator=torch.Generator().manual_seed(7))
    port.train()  # sample runs in eval mode whatever the model's mode
    with torch.no_grad():
        got = port.sample(x[:1], SAMPLES, eps=eps)
        want = ref.sample(params, bufs, x[:1].permute(0, 3, 1, 2), SAMPLES, eps)
    assert got.shape == (1, SAMPLES, *ref.image_size, ref.C) and port.training
    got = got[0].permute(0, 3, 1, 2)
    assert float((got - want).abs().max()) <= VALUE_TOL * float(want.abs().max())
    # the samples differ: z reaches the logits
    assert float((want[0] - want[1]).abs().max()) > 1e3 * VALUE_TOL * float(want.abs().max())


def test_bf16_forward_fails_the_tolerances():
    """The same comparison with the port's forward in bfloat16: a lower
    precision than the configuration's float32 fails a tolerance."""
    terms, grads = _gaps(_train_step(SEEDS[0], torch.bfloat16))
    assert terms > TERMS_TOL or grads > GRAD_TOL
    assert grads > 100 * GRAD_TOL


def test_regularized_leaves_and_noise_layout():
    """The norm sum covers the port's ``regularized_parameters``; the
    noise is one (B, latent_dim) vector an image, handed on as it is."""
    ref, port, params, _, _, _, _ = _setup(SEEDS[0])
    assert {n for n, _ in port.regularized_parameters()} == {
        k for k, t in params.items() if any(t is r for r in ref.regularized(params))}
    assert ref.noise_shapes(BATCH) == (BATCH, ref.latent_dim)
    aug = spec.cell(CELL).config["experiment"]["augmentation_options"]
    d = inputs.step_draws(SEEDS[0], 0, BATCH, ref.image_size, aug, ref.noise_shapes(BATCH), "cpu")
    assert d["z_eps"].shape == (BATCH, ref.latent_dim) and ref.to_reference(d["z_eps"]) is d["z_eps"]
    assert [b[0] for b in ref.blocks()] == ["down0", "down1", "down2", "up1", "up0"]


def test_published_widths_build():
    """At the configuration's own sizes the reference names every leaf of
    the port's registered model, with the same shapes (the model is built,
    nothing is computed)."""
    ref = reference.build(spec.cell(CELL).config["experiment"])
    port = ProbUNet(ref.C, ref.f, latent_dim=ref.latent_dim, no_convs_fcomb=ref.fcomb_depth + 1, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    have = {n: tuple(t.shape) for n, t in [*port.named_parameters(), *port.named_buffers()]}
    assert have == {name: shape for name, shape, _ in ref.specs()}
    assert len(ref.blocks()) == 13


def test_reference_imports_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); import benchmark.reference.prob_unet; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'unet_zoo_tpu_torch', 'unet_zoo_tpu', 'jax'})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
