"""The port's Probabilistic U-Net against the JAX ProbUNet on the same weights and noise.

A toy configuration with the published structure (filters (8, 16, 16, 16),
``latent_dim`` 3, ``no_convs_fcomb`` 3, 32x32, batch 2), plain and
reversible. The JAX model's variables are drawn with numpy (the shapes from
``jax.eval_shape`` of its init, which op by op would take ~20 s), carried
across with ``unet_zoo_tpu_torch.bridge``, and both packages run on the
same numpy inputs. The JAX model draws each z noise with
``jax.random.normal(make_rng("z"), shape)`` in its root scope, which
``_jax_normal`` reproduces from the same key (checked: the recovered noise
decodes to JAX's ``recon`` bit for bit); the port takes that noise as
``post_eps`` / ``eps`` / ``z_eps`` / ``loss_eps``.
"""

import copy
import dataclasses
import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_harness import _eval_inputs, root_logging  # noqa: F401 (a fixture)
from test_torch_phiseg import _close, _data, _run_jit
from test_torch_training import AUG, F32_LOSS_RTOL, _batches
from unet_zoo_tpu import metrics as jax_metrics
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.models.prob_unet import ProbUNet as JaxProbUNet
from unet_zoo_tpu.models.unet import UNet as JaxUNet
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.data import synthetic
from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
from unet_zoo_tpu_torch.models.prob_unet import REG_WEIGHT, ProbUNet
from unet_zoo_tpu_torch.models.registry import get_model
from unet_zoo_tpu_torch.models.unet import UNet
from unet_zoo_tpu_torch.training import Trainer
from unet_zoo_tpu_torch.training.cli import eval_main, train_main

FILTERS = (8, 16, 16, 16)
LATENT, FCOMB, SIZE, BATCH = 3, 3, 32, 2
MODES = ("plain", "reversible")
# f32, eval mode (BatchNorm an affine map of the running statistics): every
# output and gradient within 1e-4 of its max|ref|, the loss terms within
# 1e-5 relative, as tests/test_torch_phiseg.py holds PHiSeg (measured on the
# CPU with 1, 2 and 8 threads: outputs 3.7e-7, gradients 8.8e-6 of max,
# loss terms 9.5e-7 at worst)
F32_OF_MAX, LOSS_RTOL = 1e-4, 1e-5
# train mode, BatchNorm on batch statistics of 32 values a channel at the
# coarsest level: outputs within TRAIN_OF_MAX of max|ref| (2.5e-5 measured),
# the gradient as one vector within TRAIN_GRAD_L2 relative L2 (6.7e-5 to
# 8.1e-5 with 1 to 8 threads, so PHiSeg's 1e-4 leaves too little room), the
# running statistics within STATS_RTOL (2.2e-6 measured)
TRAIN_OF_MAX, TRAIN_GRAD_L2 = 1e-4, 3e-4
STATS_RTOL, STATS_ATOL = 1e-5, 1e-7
# the train steps, each from JAX's state: every parameter within
# STEP_PARAM_ATOL_LR * lr of JAX's after the step (measured on the CPU: 1.25e-2
# at worst, in entries whose gradient is below 1e-2 of their tensor's max,
# where Adam's update is most sensitive), except entries whose gradient
# cancels to rounding, within ROUNDING_OF_MAX of their tensor's max|g|
# (measured: 1.7e-5), which may take the other sign: those within
# ROUNDING_FLIP_LR * lr (1.9995 measured; 15 of 85616 entries over 3 steps)
STEP_PARAM_ATOL_LR, ROUNDING_OF_MAX, ROUNDING_FLIP_LR = 2e-2, 1e-4, 2.01
SAMPLES = 5
EVAL_ATOL = 1e-5
# variance-NCC of 4 samples that differ little, in f32: the port 5.1e-5 and
# JAX op by op 2.9e-5 from float64 (test_eval_image_matches_jax)
NCC_ATOL = 1e-4
TINY = dict(experiment_name="tiny_prob_unet", model="prob_unet", filter_channels=FILTERS, latent_dim=LATENT,
            no_convs_fcomb=FCOMB, n_classes=2, image_size=(SIZE, SIZE), seed=0)
OUTPUTS = ("prior_mu", "prior_sigma", "post_mu", "post_sigma", "features", "logits", "recon")


def _jax_model(mode="plain"):
    return JaxProbUNet(num_classes=2, num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=FCOMB,
                       reversible_mode=mode)


def _port_model(variables, mode="plain"):
    model = get_model("prob_unet", num_classes=2, num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=FCOMB,
                      reversible_mode=mode, device="cpu", generator=torch.Generator().manual_seed(0))
    return load_jax_params(model, variables["params"], variables["batch_stats"])


@functools.cache
def _shapes(mode):
    x, y = _data(1, (SIZE, SIZE))
    init = _jax_model(mode).init
    return jax.eval_shape(lambda r, x, y: init(r, x, y, train=True),
                          {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(y))


def _variables(mode, seed):
    """JAX variables drawn with numpy: every kernel (conv, coupling, head)
    U(+-1/sqrt(fan_in)) and the bias beside it likewise, BatchNorm and
    coupling scales U(0.8, 1.2) and shifts U(-0.1, 0.1), running means
    N(0, 0.2^2) and variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def fan_in(shape):
        return np.prod(shape[:-1])

    def fill(scope, stats):
        out = {}
        for k, leaf in scope.items():
            if isinstance(leaf, Mapping):
                out[k] = fill(leaf, stats)
                continue
            kernel = k[:-len("bias")] + "kernel" if k.endswith("bias") else None
            if stats:
                v = rng.uniform(0.5, 2.0, leaf.shape) if k.endswith("var") else 0.2 * rng.standard_normal(leaf.shape)
            elif k.endswith("kernel"):
                v = rng.uniform(-1.0, 1.0, leaf.shape) / np.sqrt(fan_in(leaf.shape))
            elif kernel in scope:
                v = rng.uniform(-1.0, 1.0, leaf.shape) / np.sqrt(fan_in(scope[kernel].shape))
            elif k.endswith("scale"):
                v = rng.uniform(0.8, 1.2, leaf.shape)
            else:  # BatchNorm's bias, a coupling function's shift
                v = rng.uniform(-0.1, 0.1, leaf.shape)
            out[k] = v.astype(np.float32)
        return out

    shapes = _shapes(mode)
    return {"params": fill(shapes["params"], False), "batch_stats": fill(shapes["batch_stats"], True)}


def _jax_normal(key, shape):
    """The noise ``jax.random.normal(self.make_rng("z"), shape)`` draws in
    the JAX ProbUNet's root scope from ``rngs={"z": key}``."""
    return np.array(_jax_model().apply({}, method=lambda m: jax.random.normal(m.make_rng("z"), shape),
                                       rngs={"z": key}))


def _run(mode, train, seed, grads=True):
    """JAX's forward with the mask, its loss, (``grads``) gradients and batch
    statistics, and the port's on the same weights and noise."""
    x, y = _data(BATCH, (SIZE, SIZE), seed)
    jm, variables, key = _jax_model(mode), _variables(mode, seed), jax.random.PRNGKey(seed)

    def loss_fn(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                            jnp.asarray(y), train=train, rngs={"z": key}, mutable=["batch_stats"])
        loss, aux = jm.loss(out, jnp.asarray(y), params)
        return loss, (out, aux, mut.get("batch_stats", {}))

    if grads:
        (_, (out, aux, stats)), jgrads = _run_jit(jax.value_and_grad(loss_fn, has_aux=True), variables["params"])
    else:
        (_, (out, aux, stats)), jgrads = _run_jit(loss_fn, variables["params"]), None
    model = _port_model(variables, mode).train(train)
    eps = torch.from_numpy(_jax_normal(key, (BATCH, LATENT)))
    tout = model(torch.from_numpy(x), torch.from_numpy(y), post_eps=eps)
    tloss, taux = model.loss(tout, torch.from_numpy(y))
    if grads:
        tloss.backward()
    return dict(out=jax.device_get(out), aux=jax.device_get(aux), grads=jax.device_get(jgrads),
                variables=variables, stats=jax.device_get(stats) or variables["batch_stats"], model=model,
                tout=tout, taux=taux, x=x, y=y)


@functools.cache
def _eval(mode="plain"):
    """Eval mode; gradients of the plain model only."""
    return _run(mode, train=False, seed=1, grads=mode == "plain")


@functools.cache
def _train():
    return _run("plain", train=True, seed=2)


def _grads(r):
    want = state_dict_from_jax(r["grads"], r["model"], r["stats"])
    got = dict(r["model"].named_parameters())
    assert all(p.grad is not None for p in got.values())
    return {k: got[k].grad for k in got}, {k: want[k] for k in got}


@pytest.mark.parametrize("mode", MODES)
def test_bridge_maps_every_leaf(mode):
    """Every JAX leaf lands on one port tensor and none is left over (the
    bridge raises on either); the encoders' reversible levels have
    ``depth_per_block - 1`` = 2 coupling blocks on both sides and the trunk's
    3; the trunk has no ``last``."""
    variables = _variables(mode, 0)
    model = _port_model(variables, mode)
    flat = state_dict_from_jax(variables["params"], model, variables["batch_stats"])
    assert set(flat) == set(model.state_dict())
    assert "last" not in variables["params"]["unet"] and model.unet.last is None
    assert not any(k.startswith("unet.last.") for k in flat)
    if mode == "reversible":
        enc = model.prior_net.encoder
        assert isinstance(enc.rev2, ops.ReversibleSequence) and enc.rev2.depth == 2
        assert set(variables["params"]["prior_net"]["encoder"]["rev2"]) == {
            f"block{i}_{fg}_{leaf}" for i in range(2) for fg in "fg" for leaf in ("kernel", "bias", "scale", "shift")}
        assert model.unet.down1.rev.depth == 3
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax({k: v for k, v in variables["params"].items() if k != "last_conv"}, model,
                            variables["batch_stats"])


def test_unet_without_last_layer_matches_jax():
    """``UNet(apply_last_layer=False)``: no ``last`` parameters, the up0
    features returned (``FILTERS[0]`` channels) as the JAX model's."""
    x = _data(BATCH, (SIZE, SIZE), 3)[0]
    jm = JaxUNet(num_classes=2, num_filters=FILTERS, apply_last_layer=False)
    params = jax.device_get(_run_jit(lambda r, x: jm.init({"params": r}, x, train=False)["params"],
                                     jax.random.PRNGKey(0), jnp.asarray(x)))
    assert "last" not in params
    model = UNet(2, FILTERS, apply_last_layer=False)
    assert model.last is None and not any("last" in k for k in model.state_dict())
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (BATCH, SIZE, SIZE, FILTERS[0])
    _close(got, jm.apply({"params": params}, jnp.asarray(x), train=False), F32_OF_MAX, "features")


@pytest.mark.parametrize("mode", MODES)
def test_eval_forward_matches_jax(mode):
    """Eval mode, JAX's posterior noise fed in: every output of the dict
    within F32_OF_MAX of its max|ref|, the loss terms within LOSS_RTOL,
    the running statistics untouched."""
    r = _eval(mode)
    assert set(r["tout"]) == set(r["out"]) == set(OUTPUTS)
    for key in OUTPUTS:
        _close(r["tout"][key], r["out"][key], F32_OF_MAX, f"{mode} eval {key}")
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(r["taux"][key].item(), float(r["aux"][key]), rtol=LOSS_RTOL, err_msg=key)
    bridged = state_dict_from_jax(r["variables"]["params"], r["model"], r["stats"])
    assert all(torch.equal(v, bridged[k]) for k, v in r["model"].state_dict().items() if "running" in k
               or k.endswith(("_mean", "_var")))


def test_eval_gradients_match_jax():
    """Every gradient within F32_OF_MAX of its max|g|: the BN-followed conv
    biases of the encoders and ``fcomb`` carry only the regularizer's term,
    REG_WEIGHT * b / sqrt(sum(b^2) + 1e-12); ``last_conv``'s is an exact zero
    tensor on both sides."""
    got, want = _grads(_eval())
    for k in got:
        assert (got[k] - want[k]).abs().max() <= F32_OF_MAX * want[k].abs().max(), k
    params = dict(_eval()["model"].named_parameters())
    followed = [n for n in params if n.endswith("conv.bias") and f"{n[:-len('conv.bias')]}bn.weight" in params]
    assert len(followed) == 2 * 3 * len(FILTERS) + FCOMB - 1
    for n in followed:
        b = params[n].detach()
        torch.testing.assert_close(got[n], REG_WEIGHT * b / torch.sqrt(b.square().sum() + 1e-12), rtol=1e-5, atol=0)
    for n in ("last_conv.conv.weight", "last_conv.conv.bias"):
        assert not want[n].any() and torch.equal(got[n], torch.zeros_like(got[n])), n


def test_train_forward_loss_and_gradient_match_jax():
    """Train mode: outputs within TRAIN_OF_MAX of max|ref| (``logits`` are
    skipped in training, as XLA drops them from the JAX step), the loss terms
    within LOSS_RTOL, the whole gradient within TRAIN_GRAD_L2 relative L2,
    the running statistics as JAX moves them."""
    r = _train()
    assert set(r["tout"]) == set(OUTPUTS) - {"logits"}  # no loss term reads them
    for key in set(OUTPUTS) - {"logits"}:
        _close(r["tout"][key], r["out"][key], TRAIN_OF_MAX, f"train {key}")
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(r["taux"][key].item(), float(r["aux"][key]), rtol=LOSS_RTOL, err_msg=key)
    got, want = _grads(r)
    flat = lambda d: torch.cat([t.flatten() for t in d.values()])  # noqa: E731
    assert (flat(got) - flat(want)).norm() <= TRAIN_GRAD_L2 * flat(want).norm()
    want_stats = state_dict_from_jax(r["variables"]["params"], r["model"], r["stats"])
    names = [k for k in want_stats if "running" in k]
    assert names
    for k in names:
        np.testing.assert_allclose(r["model"].state_dict()[k].numpy(), want_stats[k].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)


def test_regularizer_matches_jax_leaf_for_leaf():
    """The regularizer alone (the loss of fixed outputs): the leaves with a
    gradient are JAX's, leaf for leaf, with ``fcomb.last``, the trunk and
    ``last_conv`` left out, and each gradient and the term's value agree."""
    r = _eval()
    jm, params = _jax_model(), r["variables"]["params"]
    out = jax.tree_util.tree_map(jnp.asarray, r["out"])
    y = jnp.asarray(r["y"])
    reg_jax, grads = jax.value_and_grad(lambda p: jm.loss(out, y, p)[0] - jm.loss(out, y)[0])(params)
    model = copy.deepcopy(r["model"])
    want = state_dict_from_jax(jax.device_get(grads), model, r["stats"])
    model.zero_grad(set_to_none=True)
    tout = {k: v.detach() for k, v in r["tout"].items()}
    loss, aux = model.loss(tout, torch.from_numpy(r["y"]))
    (loss - aux["kl"] - aux["recon"]).backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in model.named_parameters()}
    names = {n for n, _ in model.regularized_parameters()}
    assert names == {n for n in got if want[n].any()} == {n for n in got if got[n].any()}
    assert not any(n.startswith(("fcomb.last.", "unet.", "last_conv.")) for n in names)
    assert {n.split(".")[0] for n in names} == {"prior_net", "posterior_net", "fcomb"}
    for n in got:
        torch.testing.assert_close(got[n], want[n], rtol=1e-5, atol=1e-12, msg=n)
    np.testing.assert_allclose((loss - aux["kl"] - aux["recon"]).item(), float(reg_jax), rtol=1e-4)


def test_sample_matches_jax():
    """(B=2, n=5) prior samples on JAX's noise: the folded batch is image
    0's n samples, then image 1's, as ``jnp.repeat`` (``Tensor.repeat``
    would pair image 0's features with image 1's z)."""
    x = _data(BATCH, (SIZE, SIZE), 4)[0]
    variables, key = _variables("plain", 4), jax.random.PRNGKey(4)
    jm = _jax_model()
    want = _run_jit(lambda v, x: jm.apply(v, x, SAMPLES, method=JaxProbUNet.sample, rngs={"z": key}),
                    variables, jnp.asarray(x))
    model = _port_model(variables).train()
    eps = torch.from_numpy(_jax_normal(key, (BATCH, SAMPLES, LATENT)))
    with torch.no_grad():
        got = model.sample(torch.from_numpy(x), SAMPLES, eps=eps)
    assert model.training and got.shape == (BATCH, SAMPLES, SIZE, SIZE, 2)
    _close(got, want, F32_OF_MAX, "sample")
    assert not torch.allclose(got[:, 0], got[:, 1])


def test_bf16_cast_points():
    """bf16 compute: features, ``recon`` and ``logits`` in bf16, mu and
    sigma float32, the loss float32 and finite."""
    variables = _variables("plain", 5)
    model = get_model("prob_unet", num_classes=2, num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=FCOMB,
                      dtype=torch.bfloat16, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    x, y = (torch.from_numpy(a) for a in _data(BATCH, (SIZE, SIZE), 5))
    out = model(x, y)
    assert all(out[k].dtype == torch.bfloat16 for k in ("features", "recon"))
    assert all(out[k].dtype == torch.float32 for k in ("prior_mu", "prior_sigma", "post_mu", "post_sigma"))
    loss, _ = model.loss(out, y)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    with torch.no_grad():
        assert model.sample(x, 2).dtype == torch.bfloat16
        assert model.eval()(x)["logits"].dtype == torch.bfloat16


# the harness: three Trainer steps and one evaluated image against the JAX Trainer's


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """A JAX ``Trainer`` for TINY on numpy-drawn variables in place of its
    own init."""
    jcfg = JaxExperimentConfig(**TINY, batch_size=BATCH, augmentation_options=jax_options(AUG))
    variables = _variables("plain", 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxProbUNet, "init", lambda self, *args, **kwargs: variables)
        return JaxTrainer(jcfg, log_dir=str(tmp_path_factory.mktemp("jax_prob_unet")), tensorboard=False)


def _port_trainer(jtr, tmp_path, **kw):
    tr = Trainer(ExperimentConfig(**TINY, batch_size=BATCH, augmentation_options=AUG, **kw), device="cpu",
                 log_dir=str(tmp_path), tensorboard=False)
    load_jax_params(tr.state.model, jax.device_get(jtr.state.params), jax.device_get(jtr.state.batch_stats))
    return tr


def _sync(tr, jstate):
    """The port's train state set to JAX's: parameters, running statistics
    and Adam's moments (its step count and the scheduler already agree)."""
    model, params, stats = tr.state.model, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    load_jax_params(model, params, stats)
    adam = jstate.opt_state.inner_state[1]
    moments = [state_dict_from_jax(jax.device_get(m), model, stats) for m in (adam.mu, adam.nu)]
    for n, p in model.named_parameters():
        if p in tr.state.optimizer.state:
            # contiguous, as the parameter: fused Adam pairs their elements by memory order
            tr.state.optimizer.state[p].update(exp_avg=moments[0][n].contiguous(),
                                               exp_avg_sq=moments[1][n].contiguous())


def test_train_steps_match_jax_f32(jax_trainer, tmp_path):
    """Three f32 steps on JAX's augmentation draws and z noise, each from
    JAX's state before it (``_sync``): the loss within F32_LOSS_RTOL and
    every parameter and running statistic within STEP_PARAM_ATOL_LR * lr of
    JAX's after the step, ``last_conv`` included (its gradient an exact zero;
    Adam moves it by the weight decay alone). Not free trajectories:
    gradient entries that cancel to rounding (up0's last biases of channels
    that ReLU passes everywhere, whose cotangent fcomb's train-mode
    BatchNorm centres) take either sign, and Adam's first update, lr *
    sign(g), turns that into 2 lr, which the next steps carry into every
    gradient. So an entry may differ by up to ROUNDING_FLIP_LR * lr where
    the port's gradient is within ROUNDING_OF_MAX of its tensor's max|g|,
    and only there, in at most 1e-3 of all entries."""
    jtr, lr = jax_trainer, jax_trainer.cfg.learning_rate
    jstate = jtr.state
    tr = _port_trainer(jtr, tmp_path)
    step = jax.jit(jtr._step_fn).lower(jstate, jnp.zeros((BATCH, SIZE, SIZE, 1)), jnp.zeros(
        (BATCH, SIZE, SIZE), jnp.int32)).compile({"xla_backend_optimization_level": 0})
    xs, ys = _batches(3)
    params = dict(tr.state.model.named_parameters())
    last = params["last_conv.conv.weight"]
    flipped = 0
    for i in range(3):
        _sync(tr, jstate)
        _, k_aug, k_z = jax.random.split(jstate.rng, 3)  # as _step_fn_inner splits it
        draws = jax_draws(k_aug, BATCH, (SIZE, SIZE), AUG)
        z_eps = torch.from_numpy(_jax_normal(k_z, (BATCH, LATENT)))
        before = last.detach().clone()
        jstate, jaux = step(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        aux = tr.train_step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), draws, z_eps)
        want_loss = float(jaux["loss"])
        assert abs(aux["loss"].item() - want_loss) <= F32_LOSS_RTOL * want_loss, (i, aux["loss"], want_loss)
        assert tr.state.step == int(jstate.step) == i + 1
        want = state_dict_from_jax(jax.device_get(jstate.params), tr.state.model, jax.device_get(jstate.batch_stats))
        for n, t in tr.state.model.state_dict().items():
            diff = (t - want[n]).abs()
            if n not in params:  # a running statistic
                assert diff.max() <= STEP_PARAM_ATOL_LR * lr, (i, n, diff.max().item())
                continue
            g = params[n].grad.abs()
            off = diff > STEP_PARAM_ATOL_LR * lr
            assert not (off & (g > ROUNDING_OF_MAX * g.max())).any(), (i, n, diff[off].max().item() / lr)
            assert diff.max() <= ROUNDING_FLIP_LR * lr, (i, n, diff.max().item() / lr)
            flipped += int(off.sum())
        assert torch.equal(last.grad, torch.zeros_like(last)) and not torch.equal(last.detach(), before)
    assert flipped <= 1e-3 * sum(p.numel() for p in params.values())


def test_eval_image_matches_jax(jax_trainer, tmp_path):
    """``Trainer.eval_image`` against ``_eval_image_fn`` with JAX's noise
    injected (the sample's from the image key, the loss repeats' from
    ``fold_in(key, 1)``): GED and Dice within EVAL_ATOL, the maps equal,
    loss, KL and recon within EVAL_ATOL relative. NCC is held within
    NCC_ATOL of the JAX package's ``variance_ncc_dist_class_first`` run op
    by op on the JAX model's samples: compiled by XLA on the CPU, that
    function gives 0.26950 on these samples, where float64 gives 0.27902,
    JAX op by op 0.27899 and the port 0.27897."""
    jtr = jax_trainer
    tr = _port_trainer(jtr, tmp_path)
    x, y_all, y_chosen = _eval_inputs(2, seed=7)
    n, n_loss, key = 4, 3, jax.random.PRNGKey(8)
    fn = jtr._eval_image_fn(n, n_loss)
    args = (jtr.state.variables, jnp.asarray(x), jnp.asarray(y_all), jnp.asarray(y_chosen), key)
    want = jax.device_get(fn.lower(*args).compile({"xla_backend_optimization_level": 0})(*args))
    samples = _run_jit(lambda v, x: jtr.model.apply(v, x, n, train=False, method=jtr.model.sample, rngs={"z": key}),
                       *args[:2])
    probs_cf = jax.nn.softmax(jnp.moveaxis(samples[0], -1, 0), axis=0)
    gt_cf = jnp.stack([(jnp.asarray(y_all) == c).astype(jnp.float32) for c in range(2)])
    want_ncc = float(jax_metrics.variance_ncc_dist_class_first(probs_cf, gt_cf))
    eps = torch.from_numpy(_jax_normal(key, (1, n, LATENT)))
    loss_eps = torch.from_numpy(_jax_normal(jax.random.fold_in(key, 1), (n_loss, LATENT)))
    tx, ty_all, ty_chosen = (torch.from_numpy(a) for a in (x, y_all, y_chosen))
    got = tr.eval_image(tx, ty_all, ty_chosen, n, n_loss=n_loss, eps=eps, loss_eps=loss_eps)
    assert set(got) == set(want)
    for k in ("ged", "dice"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=EVAL_ATOL, err_msg=k)
    np.testing.assert_allclose(got["ncc"].item(), want_ncc, rtol=0, atol=NCC_ATOL, err_msg="ncc")
    for k in ("mean_pred", "sample0"):
        assert got[k].dtype == torch.int32 and np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("loss", "kl", "recon"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=EVAL_ATOL, err_msg=k)
    assert tr.state.model.training
    # without noise given, it comes from eval_generator(salt, index)
    a, b, c = (tr.eval_image(tx, ty_all, ty_chosen, n, index=i) for i in (0, 0, 1))
    assert torch.equal(a["loss"], b["loss"]) and not torch.equal(a["loss"], c["loss"])


@pytest.mark.parametrize("name", ["prob_unet", "prob_unet_reversible"])
def test_experiments_match_jax(name):
    """Every field the port carries has the JAX entry's value, and the
    model's constructor arguments agree."""
    got, want = get_experiment(name), jax_get_experiment(name)
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(got.augmentation_options) == {
        k: v for k, v in dataclasses.asdict(want.augmentation_options).items() if k != "warp_precision"}
    kw, jkw = got.model_kwargs(), want.model_kwargs()
    assert {k: kw[k] for k in jkw if k != "dtype"} == {k: v for k, v in jkw.items() if k != "dtype"}
    assert kw["latent_dim"] == 6 and kw["no_convs_fcomb"] == 3
    model = get_model(got.model, **kw, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, ProbUNet)
    assert any(isinstance(m, ops.ReversibleSequence) for m in model.modules()) == (name == "prob_unet_reversible")


def test_entry_points_run_on_the_card_by_default(monkeypatch, tmp_path):
    """With no card, ``get_model`` and ``Trainer`` raise unless asked for
    the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(num_classes=2, num_filters=FILTERS, latent_dim=LATENT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("prob_unet", **kw)
    assert isinstance(get_model("prob_unet", device="cpu", **kw), ProbUNet)
    cfg = ExperimentConfig(**TINY, augmentation_options=AUG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


def test_same_seed_same_weights_and_draws():
    kw = dict(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=FCOMB)
    a, b = (ProbUNet(2, **kw, generator=torch.Generator().manual_seed(5)) for _ in range(2))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.from_numpy(_data(1, (SIZE, SIZE))[0])
    with torch.no_grad():
        assert torch.equal(a.sample(x, 2), b.sample(x, 2))


def test_cli_trains_and_evaluates(tmp_path, monkeypatch, root_logging):
    """``python -m unet_zoo_tpu_torch.train|eval`` on a ProbUNet experiment
    file and a synthetic LIDC pickle, on the CPU: the checkpoints, the
    metrics and ``test_results.npz``."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    synthetic.make_lidc_pickle("data/data_lidc.pickle", num_cases=20, num_subjects=10, size=SIZE)
    (tmp_path / "exp.py").write_text(
        "from unet_zoo_tpu_torch.experiments import ExperimentConfig\n"
        "config = ExperimentConfig(experiment_name='CliProb', model='prob_unet', filter_channels=(4, 8),\n"
        "    latent_dim=3, no_convs_fcomb=3, image_size=(32, 32), batch_size=2, iterations=4, validation_frequency=2,\n"
        "    logging_frequency=1, num_validation_images=2, validation_samples=2)\n")
    assert train_main(["exp.py", "--log-root", "runs", "--device", "cpu"]) == 0
    log_dir = tmp_path / "runs" / "lidc" / "CliProb"
    for name in ("last", "best_loss", "best_ged", "metrics_validation.jsonl", "metrics_train.jsonl"):
        assert (log_dir / name).exists(), name
    assert torch.load(log_dir / "last", weights_only=True)["step"] == 4
    assert eval_main(["exp.py", "--log-root", "runs", "--num-repeats", "1", "--num-samples", "2",
                      "--checkpoint", "best_loss", "--device", "cpu"]) == 0
    with np.load(log_dir / "test_results.npz") as f:
        assert np.isfinite(f["ged"]).all() and f["dice"].shape[-1] == 2
