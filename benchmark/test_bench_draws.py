"""The draws that the program and the reference both receive, pinned: the
sum and the sum of squares (float64) of each draw of three train steps and
of three evaluated images at the tests' size, seed ``tiny.SEED``, on the
CPU's generator, and the noise's shapes: a change to how the draws are
reckoned that moves any draw of an existing cell fails here. And a family
whose noise is one vector an image is drawn as such and kept in that
layout."""

import pytest
import torch

from benchmark import tiny
from benchmark.harness import common, inputs

AUGMENTATION = {"gate": (9.0, 9.0), "angle": (20.694270849227905, 456.7529336947809), "r": (-21.0, 859.0),
                "off_r": (94.0, 1350.0), "off_c": (106.0, 1570.0), "flip_lr": (6.0, 6.0), "flip_ud": (4.0, 4.0)}
PINNED = {
    "phiseg_lidc.train_bs12": {**AUGMENTATION, "z_eps": (-26.99143332769745, 1858.8066527092856)},
    "unet_lidc.train_bs12": AUGMENTATION,
    "phiseg_lidc.eval100": {"eps": (11.405106745485682, 1949.3988259750597),
                            "loss_eps": (39.44622090400662, 1002.8997539983557)},
}
SHAPES = {
    "phiseg_lidc.train_bs12": {"z_eps": [(4, 8, 8, 2), (4, 4, 4, 2)]},
    "unet_lidc.train_bs12": {},
    "phiseg_lidc.eval100": {"eps": [(1, 4, 8, 8, 2), (1, 4, 4, 4, 2)],
                            "loss_eps": [(1, 8, 8, 2), (1, 4, 4, 2), (1, 8, 8, 2), (1, 4, 4, 2)]},
}


def _tensors(x):
    return [x] if isinstance(x, torch.Tensor) else [t for e in x for t in _tensors(e)]


def _draws(name):
    c, overrides = tiny.cell(name)
    m = common.reference_model(c, overrides)
    if c.workload["kind"] == "train":
        batch, aug = overrides["batch_size"], c.config["experiment"]["augmentation_options"]
        return [inputs.step_draws(tiny.SEED, k, batch, m.image_size, aug, m.noise_shapes(batch), "cpu")
                for k in range(3)]
    noise = m.image_noise_shapes(c.workload["samples"], c.workload["n_loss"])
    return [inputs.image_draws(tiny.SEED, j, noise, "cpu") for j in range(3)]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_draws_are_pinned(name):
    draws = _draws(name)
    assert set(draws[0]) == set(PINNED[name])
    for key, (total, squares) in PINNED[name].items():
        leaves = [t.double() for d in draws for t in _tensors(d[key])]
        assert sum(float(t.sum()) for t in leaves) == pytest.approx(total, rel=1e-9, abs=1e-9), key
        assert sum(float(t.square().sum()) for t in leaves) == pytest.approx(squares, rel=1e-9), key
    for key, shapes in SHAPES[name].items():
        assert [tuple(t.shape) for t in _tensors(draws[0][key])] == shapes


def test_flat_noise_is_drawn_and_passed_through_unpermuted():
    batch, latent_dim, samples, n_loss = 4, 6, 5, 2
    aug = tiny.cell("phiseg_lidc.train_bs12")[0].config["experiment"]["augmentation_options"]
    d = inputs.step_draws(tiny.SEED, 0, batch, (16, 16), aug, (batch, latent_dim), "cpu")
    # one (B, latent_dim) tensor: the generator's next normals after the augmentation's, row by row
    g = inputs.generator("cpu", tiny.SEED, inputs.STEP, 0)
    torch.rand((7, batch), generator=g)
    assert torch.equal(d["z_eps"], torch.randn(batch * latent_dim, generator=g).view(batch, latent_dim))
    e = inputs.image_draws(tiny.SEED, 0, ((1, samples, latent_dim), (n_loss, latent_dim)), "cpu")
    g = inputs.generator("cpu", tiny.SEED, inputs.IMAGE, 0)
    flat = torch.randn(samples * latent_dim + n_loss * latent_dim, generator=g)
    assert torch.equal(e["eps"], flat[:samples * latent_dim].view(1, samples, latent_dim))
    assert torch.equal(e["loss_eps"], flat[samples * latent_dim:].view(n_loss, latent_dim))

