"""The port's PHiSeg3D against the JAX PHiSeg3D on the same weights and noise.

A toy of ``phiseg_brats``'s structure (filters 2/4/4, 2 latent levels,
16^3, batch 2, 4 channels, 3 one-hot WT/TC/ET classes), plain and
reversible (``REV_DEPTHS_3D``). The JAX variables are drawn with numpy
(shapes from ``jax.eval_shape`` of the init; conv kernels and biases
U(+-1/sqrt(fan_in)), a tenth of that in the ``mu``/``sigma`` heads,
BatchNorm's affine parameters and running statistics away from 1 and 0)
and carried across with ``unet_zoo_tpu_torch.bridge`` (DHWIO -> OIDHW). The
z noise of the JAX run is recovered from its outputs, eps = (z - mu) /
sigma, and injected into the port; eps depends on the key and the shapes
alone, so the train-mode run keyed with the JAX step's z key also gives
that step's noise.

One jitted JAX graph a memory mode (train- and eval-mode loss and
gradients, and the prior and likelihood on the port's sampled z) and the
JAX ``Trainer._step_fn`` once.

Tolerances (f32): outputs within 1e-4 of max|ref|; loss, KL and recon within
1e-4 relative; the whole train-mode gradient within 1e-3 relative L2, and in
eval mode (BatchNorm an affine map) each tensor's within 1e-3 relative L2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_3d_options, jax_draws_3d
from test_torch_phiseg import _run_jit
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.models.registry import get_model as jax_get_model
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.data.augment import Augment3DOptions
from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
from unet_zoo_tpu_torch.models.phiseg import REV_DEPTHS_3D, PHiSeg
from unet_zoo_tpu_torch.models.registry import get_model
from unet_zoo_tpu_torch.ops import ReversibleSequence
from unet_zoo_tpu_torch.training import Trainer

MODES = ("plain", "reversible")
SIZE = (16, 16, 16)
TINY = dict(experiment_name="tiny_phiseg3d", log_dir_name="brats", model="phiseg3d", data_loader="brats",
            filter_channels=(2, 4, 4), latent_levels=2, n_classes=3, num_labels_per_subject=1, input_channels=4,
            batch_size=2, image_size=SIZE)
OUT_OF_MAX = 1e-4
LOSS_RTOL = 1e-4
GRAD_L2 = 1e-3
STATS_OF_MAX = 1e-5
PARAM_ATOL_LR = 1e-2  # after one Adam step, as the 2D step tests
SAMPLES = 3


def _data(seed):
    """Smooth 4-channel noise volumes and nested WT/TC/ET one-hot labels."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((2, 18, 18, 18, 4)).astype(np.float32)
    x = sum(noise[:, i:i + 16, j:j + 16, k:k + 16] for i in range(3) for j in range(3) for k in range(3)) / 5
    lbl = np.array([0, 1, 2, 4])[np.digitize(x[..., 0], [0.0, 0.4, 0.8])]
    y = np.stack([lbl != 0, (lbl != 0) & (lbl != 2), lbl == 4], -1).astype(np.float32)
    return x.astype(np.float32), y


def _jax_model(mode):
    return jax_get_model("phiseg3d", num_classes=3, num_filters=TINY["filter_channels"], latent_levels=2,
                         image_size=SIZE, reversible_mode=mode)


def _variables(mode, seed):
    """The JAX variables of ``_jax_model(mode)`` drawn with numpy."""
    x, y = (jnp.zeros((1, *SIZE, c), jnp.float32) for c in (4, 3))
    shapes = jax.eval_shape(lambda r: _jax_model(mode).init(r, x, y, train=True),
                            {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(0)})
    rng = np.random.default_rng(seed)

    def fill(scope, stats, path=""):
        out = {}
        for k, leaf in scope.items():
            if not hasattr(leaf, "shape"):
                out[k] = fill(leaf, stats, f"{path}/{k}")
                continue
            if stats:
                v = rng.uniform(0.5, 2.0, leaf.shape) if k.endswith("var") else 0.2 * rng.standard_normal(leaf.shape)
            elif k.endswith("scale"):
                v = rng.uniform(0.8, 1.2, leaf.shape)
            elif k.endswith("shift") or (k == "bias" and "kernel" not in scope):
                v = rng.uniform(-0.1, 0.1, leaf.shape)
            else:  # a conv's kernel or bias
                kernel = scope["kernel"] if "kernel" in scope else scope[k.replace("_bias", "_kernel")]
                bound = 1.0 / np.sqrt(np.prod(kernel.shape[:-1]))
                v = rng.uniform(-bound, bound, leaf.shape) * (0.1 if path.endswith(("/mu", "/sigma")) else 1.0)
            out[k] = v.astype(np.float32)
        return out

    return {"params": fill(shapes["params"], False), "batch_stats": fill(shapes["batch_stats"], True)}


def _port_model(mode, variables):
    model = get_model("phiseg3d", num_classes=3, num_filters=TINY["filter_channels"], latent_levels=2,
                      image_size=SIZE, in_channels=4, reversible_mode=mode, device="cpu")
    return load_jax_params(model, variables["params"], variables["batch_stats"])


def _eps(z, mu, sigma):
    return [torch.from_numpy(np.array((a - b) / c)) for a, b, c in zip(z, mu, sigma)]


def _close(got, want, of_max, label):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= of_max * scale, (label, err, scale)


def _port_sample_z(model, x, eps):
    """The port's ``sample`` and, through its pieces, the folded z it decodes."""
    with torch.no_grad():
        got = model.sample(x, SAMPLES, eps=eps)
        model.eval()
        skips, bottom = model.prior.trunk(x)
        folded = [e.transpose(0, 1).reshape(SAMPLES * 2, *e.shape[2:]) for e in eps]
        z, _, _ = model.prior.zpath([s.repeat(SAMPLES, 1, 1, 1, 1) for s in skips], bottom.repeat(SAMPLES, 1, 1, 1, 1),
                                    eps=folded)
    return got, z, folded


def _step_keys(seed=0):
    """(state.rng, k_aug, k_z) of the first ``_step_fn`` of a JAX Trainer
    seeded ``seed``: its state's key is ``split(PRNGKey(seed), 3)[2]``, and
    the step splits it in three."""
    rng = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    return (rng, *jax.random.split(rng, 3)[1:])


@functools.cache
def _run(mode):
    """JAX's train-mode and eval-mode loss, outputs, batch statistics and
    gradients, and its prior and likelihood on the port's sampled z, in one
    graph; and the port's train- and eval-mode runs on the same weights and
    eps. The z key is the first JAX step's (``_step_keys``)."""
    x, y = _data(1)
    jm = _jax_model(mode)
    variables = _variables(mode, 3)
    key = _step_keys()[2]
    model = _port_model(mode, variables)
    rng = np.random.default_rng(4)
    sample_eps = [torch.from_numpy(rng.standard_normal((2, SAMPLES, *[s // 2 ** (lvl + 1) for s in SIZE], 2))
                                   .astype(np.float32)) for lvl in range(2)]
    sampled, z, folded = _port_sample_z(model, torch.from_numpy(x), sample_eps)

    def everything(params, x, y, key, zf):
        def loss_fn(params, train):
            out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, y, train=train,
                                rngs={"z": key}, mutable=["batch_stats"])
            loss, aux = jm.loss(out, y)
            return loss, (out, aux, mut.get("batch_stats", {}))

        train = jax.value_and_grad(functools.partial(loss_fn, train=True), has_aux=True)(params)
        evals = jax.value_and_grad(functools.partial(loss_fn, train=False), has_aux=True)(params)
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        xf = jnp.tile(x, (SAMPLES, 1, 1, 1, 1))
        _, mu, sigma = jm.apply(v, xf, zf, rngs={"z": key}, method=lambda m, x, t: m.prior(x, None, t, train=False))
        logits = jm.apply(v, zf, method=lambda m, t: m.accumulate_output(m.likelihood(t, train=False)))
        return train, evals, (mu, sigma, logits)

    train, evals, prior = jax.device_get(_run_jit(everything, variables["params"], jnp.asarray(x), jnp.asarray(y),
                                                  key, [jnp.asarray(t.numpy()) for t in z]))
    (_, (out, aux, stats)), grads = train
    (_, (eout, eaux, _)), egrads = evals
    port = {}
    for phase, o in (("train", out), ("eval", eout)):
        m = _port_model(mode, variables).train(phase == "train")
        tout = m(torch.from_numpy(x), torch.from_numpy(y), post_eps=_eps(o["post_z"], o["post_mu"], o["post_sigma"]),
                 prior_eps=None if phase == "train" else _eps(o["prior_z"], o["prior_mu"], o["prior_sigma"]))
        tloss, taux = m.loss(tout, torch.from_numpy(y))
        tloss.backward()
        port[phase] = dict(model=m, out=tout, aux=taux)
    return dict(variables=variables, out=out, aux=aux, stats=stats, grads=grads, eout=eout, eaux=eaux,
                egrads=egrads, prior=prior, sampled=sampled, z=z, folded=folded, port=port,
                eps=_eps(out["post_z"], out["post_mu"], out["post_sigma"]), x=x, y=y)


def _grads(r, phase, grads):
    model = r["port"][phase]["model"]
    want = state_dict_from_jax(grads, model, r["variables"]["batch_stats"])
    params = dict(model.named_parameters())
    assert all(p.grad is not None for p in params.values())
    return {k: params[k].grad for k in params}, {k: want[k] for k in params}


@pytest.mark.parametrize("mode", MODES)
def test_train_forward_and_loss_match_jax(mode):
    r = _run(mode)
    tout, taux = r["port"]["train"]["out"], r["port"]["train"]["aux"]
    for key in ("s_list", "post_mu", "post_sigma", "prior_mu", "prior_sigma", "post_z"):
        assert len(tout[key]) == 2
        for lvl, (got, want) in enumerate(zip(tout[key], r["out"][key])):
            _close(got, want, OUT_OF_MAX, f"{mode} {key}[{lvl}]")
    assert tout["s_list"][0].shape == (2, *SIZE, 3)
    assert all(torch.equal(a, b) for a, b in zip(tout["prior_z"], tout["post_z"]))  # teacher forcing
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(taux[key].item(), float(r["aux"][key]), rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_train_gradient_and_stats_match_jax(mode):
    """The whole gradient within GRAD_L2; the biases that BatchNorm follows
    (and the coupling blocks') an exact zero on both sides; the running
    statistics after the forward."""
    r = _run(mode)
    got, want = _grads(r, "train", r["grads"])
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa: E731
    assert (flat(got) - flat(want)).norm() <= GRAD_L2 * flat(want).norm()
    zero = [k for k in got if k.endswith("_bias") or (k.endswith("conv.bias") and "head" not in k)]
    assert zero and all(not got[k].any() and not want[k].any() for k in zero)
    model = r["port"]["train"]["model"]
    stats = state_dict_from_jax(r["variables"]["params"], model, r["stats"])
    for name, b in model.named_buffers():
        assert (b - stats[name]).abs().max() <= STATS_OF_MAX * stats[name].abs().max(), name


@pytest.mark.parametrize("mode", MODES)
def test_eval_forward_and_gradients_match_jax(mode):
    """Eval mode with the mask: the prior's z decoded, BatchNorm on the
    running statistics; every gradient tensor within GRAD_L2."""
    r = _run(mode)
    tout = r["port"]["eval"]["out"]
    for key in ("s_list", "post_mu", "prior_mu", "prior_sigma"):
        for lvl, (got, want) in enumerate(zip(tout[key], r["eout"][key])):
            _close(got, want, OUT_OF_MAX, f"{mode} eval {key}[{lvl}]")
    np.testing.assert_allclose(r["port"]["eval"]["aux"]["loss"].item(), float(r["eaux"]["loss"]), rtol=LOSS_RTOL)
    got, want = _grads(r, "eval", r["egrads"])
    for k in got:
        assert (got[k] - want[k]).norm() <= GRAD_L2 * want[k].norm() + 1e-12, (mode, k)


@pytest.mark.parametrize("mode", MODES)
def test_sample_matches_jax(mode):
    """The port's folded z are mu + sigma * eps of the JAX prior's own mu and
    sigma (the port's z given as teacher z), and the JAX likelihood of those
    z, accumulated, is the port's sample."""
    r = _run(mode)
    mu, sigma, logits = r["prior"]
    for lvl in range(2):
        _close(r["z"][lvl], mu[lvl] + sigma[lvl] * r["folded"][lvl].numpy(), OUT_OF_MAX, f"{mode} z[{lvl}]")
    want = np.moveaxis(np.asarray(logits).reshape(SAMPLES, 2, *logits.shape[1:]), 0, 1)
    assert r["sampled"].shape == (2, SAMPLES, *SIZE, 3)
    _close(r["sampled"], want, OUT_OF_MAX, f"{mode} sample")


@pytest.mark.parametrize("mode", MODES)
def test_chunked_sample_is_the_whole_fold(mode):
    """Decoding the fold a few samples at a time draws and decodes what the
    whole fold does, from the generator or from given eps."""
    model = _port_model(mode, _variables(mode, 3))
    x = torch.from_numpy(_data(2)[0])
    with torch.no_grad():
        whole = model.sample(x, 5, generator=torch.Generator().manual_seed(1))
        for chunk in (1, 2, 4):
            torch.testing.assert_close(model.sample(x, 5, generator=torch.Generator().manual_seed(1), chunk=chunk),
                                       whole, rtol=0, atol=0)
    assert not torch.equal(whole[:, 0], whole[:, 1])


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """A JAX Trainer of the toy reversible PHiSeg3D with 3D augmentation on
    the numpy-drawn variables, its step's augmentation draws and z noise,
    and its ``_step_fn`` on one batch."""
    variables = _variables("reversible", 3)
    jcfg = JaxExperimentConfig(**TINY, use_reversible=True, augmentation_options_3d=jax_3d_options(Augment3DOptions()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        jtr = JaxTrainer(jcfg, log_dir=str(tmp_path_factory.mktemp("jax_phiseg3d")), tensorboard=False)
    rng, k_aug, _ = _step_keys()
    assert np.array_equal(np.asarray(jtr.state.rng), np.asarray(rng))
    x, y = _data(5)
    jstate, jaux = _run_jit(jtr._step_fn, jtr.state, jnp.asarray(x), jnp.asarray(y))
    return dict(jtr=jtr, variables=variables, x=x, y=y, draws=jax_draws_3d(k_aug, 2, 4, Augment3DOptions()),
                eps=_run("reversible")["eps"], jstate=jax.device_get(jstate), jaux=jax.device_get(jaux))


def test_train_step_matches_jax(jax_step):
    """One ``Trainer.train_step`` (3D augmentation with the elastic field,
    the reversible PHiSeg3D, coupled-L2 Adam) against the JAX ``_step_fn``
    from the same state, draws and z noise: the loss, every parameter after
    the update and the running statistics."""
    r = jax_step
    lr = r["jtr"].cfg.learning_rate
    tr = Trainer(ExperimentConfig(**TINY, use_reversible=True, augmentation_options_3d=Augment3DOptions()),
                 device="cpu")
    load_jax_params(tr.state.model, r["variables"]["params"], r["variables"]["batch_stats"])
    aux = tr.train_step(torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), r["draws"], r["eps"])
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(aux[key].item(), float(r["jaux"][key]), rtol=LOSS_RTOL, err_msg=key)
    want = state_dict_from_jax(r["jstate"].params, tr.state.model, r["jstate"].batch_stats)
    for name, v in tr.state.model.state_dict().items():
        if "_mean" in name or "_var" in name or "running" in name:
            assert (v - want[name]).abs().max() <= STATS_OF_MAX * want[name].abs().max(), name
        else:
            assert (v - want[name]).abs().max() <= PARAM_ATOL_LR * lr, name


def test_registry_and_experiment_match_jax(monkeypatch):
    """``phiseg3d`` is PHiSeg with one coupling block a reversible sequence,
    built on the card unless asked for the CPU; ``phiseg_brats`` has the JAX
    entry's fields and model kwargs."""
    got, want = get_experiment("phiseg_brats"), jax_get_experiment("phiseg_brats")
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options_3d":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(got.augmentation_options_3d) == dataclasses.asdict(want.augmentation_options_3d)
    assert got.is_3d and got.effective_reversible_mode == "reversible"
    kw = {k: v for k, v in want.model_kwargs().items() if k != "dtype"}
    assert {k: got.model_kwargs()[k] for k in kw} == kw
    model = get_model("phiseg3d", **{**got.model_kwargs(), "num_filters": (2, 4, 4), "image_size": SIZE},
                      device="cpu")
    assert isinstance(model, PHiSeg) and isinstance(model.likelihood.postc0, ReversibleSequence)
    rev = [m for m in model.modules() if isinstance(m, ReversibleSequence)]
    assert rev and all(m.depth == 1 for m in rev) and REV_DEPTHS_3D == (1, 1, 1, 1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("phiseg3d", num_classes=3, image_size=SIZE)
