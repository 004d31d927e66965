"""The port's PHiSeg 2D against the JAX PHiSeg on the same weights and noise.

Two toy configurations: a small one (4 levels, 3 latent) and the published
structure of ``phiseg_7_5_12`` (7 levels, 5 latent) at widths of at most 4,
at a size where every BatchNorm normalises over at least 8 values. The JAX
model's variables are drawn with numpy (the shapes from ``jax.eval_shape``
of its init, the values as its torch_default init draws them, BatchNorm's
affine parameters and running statistics away from 1 and 0), carried across
with ``unet_zoo_tpu_torch.bridge``, and both packages run on the same numpy
inputs. The z noise of the JAX run is recovered from its own outputs,
eps = (z - mu) / sigma, and injected into the port.
"""

import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.models.prob_unet import kl_two_gauss_diag as jax_kl
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.models.phiseg import PHiSeg
from unet_zoo_tpu_torch.models.prob_unet import kl_two_gauss_diag
from unet_zoo_tpu_torch.models.registry import get_model

CONFIGS = {
    "small": dict(num_filters=(4, 8, 8, 8), latent_levels=3, image_size=(32, 32), batch=2),
    # coarsest level 2x2 at batch 2: 8 values a channel
    "published": dict(num_filters=(2, 4, 4, 4, 4, 4, 4), latent_levels=5, image_size=(128, 128), batch=2),
}
# f32. In eval mode (BatchNorm on running statistics, an affine map) the
# two packages agree to rounding: every output and gradient within 1e-4 of
# its max|ref| (measured on the CPU over three weight draws: outputs 7e-7,
# gradients 4.3e-5 at worst).
F32_OF_MAX = 1e-4
LOSS_RTOL = 1e-5
# In train mode BatchNorm's batch statistics over a few values (8 a channel
# at the coarsest published level) amplify rounding with depth: at the
# published structure the outputs agree to 5e-5-1.7e-4 of max|ref| and the
# whole gradient to 5e-4-3.9e-3 (relative L2), single BatchNorm-parameter
# gradients, small sums of large terms, by up to 23% of their max; at the
# small config to 2.8e-5 and 2.3e-5 (measured on the CPU over three weight
# draws). The port against itself with 1 and 8 threads, the same program in
# other summation orders, differs as much. So in train mode the outputs are
# held within TRAIN_OF_MAX of max|ref| and the gradient, as one vector,
# within TRAIN_GRAD_L2 relative at the small config (at the published
# depth the gradients are held in eval mode); the losses agree to 1e-6.
TRAIN_OF_MAX = {"small": F32_OF_MAX, "published": 1e-3}
TRAIN_GRAD_L2 = 1e-4
# bf16, train mode, small config, on the same weights and eps: both cast at
# the same points, but every conv's bf16 sums round in their own order and
# the JAX model rounds each half of an implicit concat separately, through
# BN layers that amplify it as above. Measured on the CPU: s_list within
# 0.116 of max|s|, the loss within 6.5e-4 relative.
BF16_S_OF_MAX = 0.25
BF16_LOSS_RTOL = 3e-3
SAMPLES = 3


def _data(batch, size, seed=0):
    """Smooth noise, labelled where it is positive."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((batch, size[0] + 4, size[1] + 4, 1)).astype(np.float32)
    x = sum(noise[:, i:i + size[0], j:j + size[1]] for i in range(5) for j in range(5)) / 5
    return x.astype(np.float32), (x[..., 0] > 0).astype(np.int32)


def _jax_model(cfg, dtype=None):
    return JaxPHiSeg(num_classes=cfg.get("num_classes", 2), num_filters=cfg["num_filters"],
                     latent_levels=cfg["latent_levels"], image_size=cfg["image_size"], dtype=dtype)


def _run_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's lowest backend optimisation
    level: the same f32 math, about half the compile time of these graphs on
    the CPU."""
    return jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


@functools.cache
def _shapes(num_filters, latent_levels, image_size, num_classes=2):
    x, y = _data(1, image_size)
    init = _jax_model(dict(num_filters=num_filters, latent_levels=latent_levels, image_size=image_size,
                           num_classes=num_classes)).init
    return jax.eval_shape(lambda r, x, y: init(r, x, y, train=True),
                          {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(y))


def _variables(cfg, seed):
    """JAX variables of the model ``cfg`` drawn with numpy: conv kernels and
    biases U(+-1/sqrt(fan_in)) (the torch_default init), BatchNorm scale
    U(0.8, 1.2) and bias U(-0.1, 0.1), running mean N(0, 0.2^2) and variance
    U(0.5, 2)."""
    shapes = _shapes(tuple(cfg["num_filters"]), cfg["latent_levels"], tuple(cfg["image_size"]),
                     cfg.get("num_classes", 2))
    rng = np.random.default_rng(seed)

    def fill(scope, stats):
        out = {}
        for k, leaf in scope.items():
            if isinstance(leaf, Mapping):
                out[k] = fill(leaf, stats)
                continue
            if stats:
                v = rng.uniform(0.5, 2.0, leaf.shape) if k == "var" else 0.2 * rng.standard_normal(leaf.shape)
            elif "kernel" in scope:  # a conv's kernel and bias
                v = rng.uniform(-1.0, 1.0, leaf.shape) / np.sqrt(np.prod(scope["kernel"].shape[:-1]))
            else:  # BatchNorm's scale and bias
                v = rng.uniform(0.8, 1.2, leaf.shape) if k == "scale" else rng.uniform(-0.1, 0.1, leaf.shape)
            out[k] = v.astype(np.float32)
        return out

    return {"params": fill(shapes["params"], False), "batch_stats": fill(shapes["batch_stats"], True)}


def _port_model(cfg, variables, dtype=None):
    model = get_model("phiseg", num_classes=2, num_filters=cfg["num_filters"], latent_levels=cfg["latent_levels"],
                      image_size=cfg["image_size"], dtype=dtype, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return load_jax_params(model, variables["params"], variables["batch_stats"])


def _eps(z, mu, sigma):
    return [torch.from_numpy(np.array((a - b) / c)) for a, b, c in zip(z, mu, sigma)]


def _close(got, want, of_max, label):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= of_max * scale, (label, err, scale)


def _run(cfg, train, dtype=None, seed=0, grads=True):
    """JAX's forward with the mask, loss, batch statistics and (``grads``)
    gradients in train or eval mode, and the port's on the same weights and
    eps."""
    x, y = _data(cfg["batch"], cfg["image_size"], seed)
    jm = _jax_model(cfg, None if dtype is None else jnp.bfloat16)
    variables = _variables(cfg, seed)

    def loss_fn(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            jnp.asarray(y), train=train, rngs={"z": jax.random.PRNGKey(seed)}, mutable=["batch_stats"])
        loss, aux = jm.loss(out, jnp.asarray(y))
        return loss, (out, aux, mut.get("batch_stats", {}))

    if grads:
        (_, (out, aux, stats)), jgrads = _run_jit(jax.value_and_grad(loss_fn, has_aux=True), variables["params"])
    else:
        (_, (out, aux, stats)), jgrads = _run_jit(loss_fn, variables["params"]), None
    model = _port_model(cfg, variables, torch.bfloat16 if dtype else None).train(train)
    tout = model(torch.from_numpy(x), torch.from_numpy(y),
                 post_eps=_eps(out["post_z"], out["post_mu"], out["post_sigma"]),
                 prior_eps=None if train else _eps(out["prior_z"], out["prior_mu"], out["prior_sigma"]))
    tloss, taux = model.loss(tout, torch.from_numpy(y))
    if grads:
        tloss.backward()
    return dict(out=jax.device_get(out), aux=jax.device_get(aux), grads=jax.device_get(jgrads),
                params=variables["params"], stats=jax.device_get(stats) or variables["batch_stats"],
                model=model, tout=tout, taux=taux)


@functools.cache
def _train(name):
    """Train mode; gradients at the small config only (see TRAIN_GRAD_L2)."""
    return _run(CONFIGS[name], train=True, grads=name == "small")


@functools.cache
def _eval(name):
    return _run(CONFIGS[name], train=False, seed=1)


def _grads(r):
    want = state_dict_from_jax(r["grads"], r["model"], r["stats"])
    got = dict(r["model"].named_parameters())
    assert all(p.grad is not None for p in got.values())
    return {k: got[k].grad for k in got}, {k: want[k] for k in got}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_forward_matches_jax(name):
    r = _train(name)
    for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma", "post_z", "prior_z"):
        assert len(r["tout"][key]) == CONFIGS[name]["latent_levels"]
        for lvl, (got, want) in enumerate(zip(r["tout"][key], r["out"][key])):
            _close(got, want, TRAIN_OF_MAX[name], f"{name} {key}[{lvl}]")
    # teacher forcing: the prior's z are the posterior's
    assert all(torch.equal(a, b) for a, b in zip(r["tout"]["prior_z"], r["tout"]["post_z"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_loss_matches_jax(name):
    r = _train(name)
    assert set(r["taux"]) == set(r["aux"])
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(r["taux"][key].item(), float(r["aux"][key]), rtol=LOSS_RTOL, err_msg=key)


def test_gradients_match_jax():
    """The whole train-mode gradient within TRAIN_GRAD_L2; the biases of the
    convs that BatchNorm follows get an exact zero on both sides (so Adam
    still applies their weight decay), every other gradient is non-zero.
    At the published depth, where train-mode gradients are chaotic, every
    gradient is held in eval mode (``test_eval_gradients_match_jax``)."""
    name = "small"
    got, want = _grads(_train(name))
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa: E731
    assert (flat(got) - flat(want)).norm() <= TRAIN_GRAD_L2 * flat(want).norm()
    heads = [f"likelihood.head{j}.conv.bias" for j in range(CONFIGS[name]["latent_levels"])]
    for k in got:
        if k.endswith("conv.bias") and k not in heads:
            assert not want[k].any() and not got[k].any(), k
        else:
            assert want[k].any() and got[k].any(), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_running_stats_match_jax(name):
    r = _train(name)
    want = state_dict_from_jax(r["params"], r["model"], r["stats"])
    got = r["model"].state_dict()
    names = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eval_forward_decodes_the_prior(name):
    """Eval mode with a mask: the posterior is computed, the prior's z is
    decoded, BatchNorm reads the running statistics and leaves them."""
    r = _eval(name)
    for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma"):
        for lvl, (got, want) in enumerate(zip(r["tout"][key], r["out"][key])):
            _close(got, want, F32_OF_MAX, f"{name} eval {key}[{lvl}]")
    np.testing.assert_allclose(r["taux"]["loss"].item(), float(r["aux"]["loss"]), rtol=LOSS_RTOL)
    assert not torch.allclose(r["tout"]["prior_z"][0], r["tout"]["post_z"][0])
    bridged = state_dict_from_jax(r["params"], r["model"], r["stats"])
    state = r["model"].state_dict()
    assert all(torch.equal(state[k], bridged[k]) for k in state if "running" in k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eval_gradients_match_jax(name):
    """Every gradient within 1e-4 of its max|g| where BatchNorm is an affine map."""
    got, want = _grads(_eval(name))
    for k in got:
        assert (got[k] - want[k]).abs().max() <= F32_OF_MAX * want[k].abs().max(), (name, k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sample_matches_jax(name):
    """The port's z of ``SAMPLES`` prior samples, given as teacher z to the
    JAX prior, are mu + sigma * eps of its own mu and sigma at each level;
    the JAX likelihood of those z, accumulated, is the port's sample."""
    cfg = CONFIGS[name]
    x, y = _data(cfg["batch"], cfg["image_size"], seed=2)
    jm = _jax_model(cfg)
    variables = _variables(cfg, seed=7)
    model = _port_model(cfg, variables).train()  # sample() runs eval mode whatever the mode
    b, n = cfg["batch"], SAMPLES
    rng = np.random.default_rng(10)
    shapes = [(b, n, *[-(-s // 2 ** (lvl + len(cfg["num_filters"]) - cfg["latent_levels"]))
                       for s in cfg["image_size"]], 2) for lvl in range(cfg["latent_levels"])]
    eps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = model.sample(tx, n, eps=eps)
        assert model.training and got.shape == (b, n, *cfg["image_size"], 2)
        # the same draws through the port's pieces, for its z
        model.eval()
        skips, bottom = model.prior.trunk(tx)
        folded = [e.transpose(0, 1).reshape(n * b, *e.shape[2:]) for e in eps]
        z, _, _ = model.prior.zpath([s.repeat(n, 1, 1, 1) for s in skips], bottom.repeat(n, 1, 1, 1), eps=folded)
    xf = jnp.asarray(np.tile(x, (n, 1, 1, 1)))
    zf = [jnp.asarray(t.numpy()) for t in z]
    _, mu, sigma = _run_jit(lambda v, x, t: jm.apply(v, x, t, rngs={"z": jax.random.PRNGKey(11)},
                                                     method=lambda m, x, t: m.prior(x, None, t, train=False)),
                            variables, xf, zf)
    for lvl in range(cfg["latent_levels"]):
        _close(z[lvl], mu[lvl] + sigma[lvl] * jnp.asarray(folded[lvl].numpy()), F32_OF_MAX, f"{name} z[{lvl}]")
    want = _run_jit(lambda v, t: jm.apply(v, t, method=lambda m, t: m.accumulate_output(m.likelihood(t, train=False))),
                    variables, zf)
    want = np.moveaxis(np.asarray(want).reshape(n, b, *want.shape[1:]), 0, 1)
    _close(got, want, F32_OF_MAX, f"{name} sample")
    assert not torch.allclose(got[:, 0], got[:, 1])


def test_train_forward_bf16_within_bounds():
    r = _run(CONFIGS["small"], train=True, dtype="bfloat16", grads=False)
    for lvl, (got, want) in enumerate(zip(r["tout"]["s_list"], r["out"]["s_list"])):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want, np.float32), BF16_S_OF_MAX, f"bf16 s_list[{lvl}]")
    for mu, sigma in zip(r["tout"]["post_mu"], r["tout"]["post_sigma"]):
        assert mu.dtype == sigma.dtype == torch.float32
    np.testing.assert_allclose(r["taux"]["loss"].item(), float(r["aux"]["loss"]), rtol=BF16_LOSS_RTOL)


def test_loss_terms_match_jax():
    """KL with and without the parity quirk, the residual CE on integer and
    one-hot masks, and the accumulated output, on random tensors."""
    rng = np.random.default_rng(12)
    mus = [rng.standard_normal((2, 4, 4, 2)).astype(np.float32) for _ in range(2)]
    sigmas = [rng.uniform(0.1, 2.0, (2, 4, 4, 2)).astype(np.float32) for _ in range(2)]
    for parity in (True, False):
        np.testing.assert_allclose(
            kl_two_gauss_diag(*(torch.from_numpy(t) for t in (mus[0], sigmas[0], mus[1], sigmas[1])), parity=parity).item(),
            float(jax_kl(mus[0], sigmas[0], mus[1], sigmas[1], parity=parity)), rtol=1e-6)
    cfg = CONFIGS["small"]
    jm, tm = _jax_model(cfg), PHiSeg(2, cfg["num_filters"], cfg["latent_levels"], image_size=(8, 8))
    s_list = [rng.standard_normal((2, 8, 8, 2)).astype(np.float32) for _ in range(3)]
    labels = rng.integers(0, 2, (2, 8, 8))
    for mask in (labels.astype(np.int32), np.eye(2, dtype=np.float32)[labels]):
        want = jm.apply({}, [jnp.asarray(s) for s in s_list], jnp.asarray(mask), method=JaxPHiSeg.residual_multinoulli)
        got = tm.residual_multinoulli([torch.from_numpy(s) for s in s_list], torch.from_numpy(mask))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for use_softmax in (False, True):
        np.testing.assert_allclose(
            PHiSeg.accumulate_output([torch.from_numpy(s) for s in s_list], use_softmax).numpy(),
            np.asarray(JaxPHiSeg.accumulate_output([jnp.asarray(s) for s in s_list], use_softmax)), rtol=1e-6)
    mus_l = [[torch.from_numpy(m[:, :k, :k]) for k in (4, 2, 1)] for m in mus]
    sig_l = [[torch.from_numpy(s[:, :k, :k]) for k in (4, 2, 1)] for s in sigmas]
    want = jm.apply({}, *[[jnp.asarray(t.numpy()) for t in l] for l in (mus_l[0], sig_l[0], mus_l[1], sig_l[1])],
                    method=JaxPHiSeg.hierarchical_kl)
    np.testing.assert_allclose(tm.hierarchical_kl(mus_l[0], sig_l[0], mus_l[1], sig_l[1]).item(), float(want),
                               rtol=1e-6)


def test_registry_builds_phiseg_on_the_card_by_default(monkeypatch):
    cfg = CONFIGS["small"]
    kw = dict(num_classes=2, num_filters=cfg["num_filters"], latent_levels=cfg["latent_levels"],
              image_size=cfg["image_size"])
    assert isinstance(get_model("phiseg", device="cpu", **kw), PHiSeg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("phiseg", **kw)
    with pytest.raises(ValueError, match="latent_levels"):
        get_model("phiseg", device="cpu", **{**kw, "latent_levels": 5})


def test_same_seed_same_weights_and_draws():
    cfg = CONFIGS["small"]
    kw = dict(num_filters=cfg["num_filters"], latent_levels=cfg["latent_levels"], image_size=cfg["image_size"])
    a, b = (PHiSeg(2, **kw, generator=torch.Generator().manual_seed(5)) for _ in range(2))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.from_numpy(_data(1, cfg["image_size"])[0])
    with torch.no_grad():
        assert torch.equal(a.sample(x, 2), b.sample(x, 2))
