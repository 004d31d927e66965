"""The port's train step against the JAX package's, at toy shapes.

One JAX ``Trainer`` per model and dtype (module-scoped) runs its jitted
``_step_fn``; the port's ``Trainer`` starts from the same weights
(``bridge``) and takes JAX's augmentation draws (``jax_draws`` of
``tests/test_torch_augment.py``, from the key the JAX step splits off
``state.rng``) and, for PHiSeg, its z noise (recovered from one JAX
posterior forward with the step's ``z`` key). Losses, parameters,
BatchNorm's running statistics and the learning rate are compared after
every step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_phiseg import _variables as phiseg_variables
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.experiments import list_experiments as jax_list_experiments
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu.training import plateau_init as jax_plateau_init
from unet_zoo_tpu.training import plateau_update as jax_plateau_update
from unet_zoo_tpu.training.trainer import adam_coupled_l2 as jax_adam_coupled_l2
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.data.augment import AugmentOptions
from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
from unet_zoo_tpu_torch.experiments import registry
from unet_zoo_tpu_torch.training import (
    Trainer,
    adam_coupled_l2,
    plateau_init,
    plateau_update,
    restore_checkpoint,
    save_checkpoint,
)

AUG = AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=2)
TINY = dict(experiment_name="tiny_unet", model="unet", filter_channels=(4, 8, 8, 8), n_classes=2,
            image_size=(32, 32), seed=0)
TINY_PHISEG = dict(TINY, experiment_name="tiny_phiseg", model="phiseg", filter_channels=(4, 8, 8), latent_levels=2)

# f32, over 3 steps: the forwards and gradients agree to ~1e-6 relative
# (loss 1.7e-7 and parameters 3.3e-3 lr apart, measured on the CPU), so
# Adam's updates agree wherever |g| is well above eps
F32_STEPS, F32_LOSS_RTOL, F32_PARAM_ATOL_LR = 3, 1e-5, 1e-2
# bf16, one step: at these toy widths both packages' bf16 gradients lie
# 5-50% (relative L2, per tensor) from the f32 gradient of the same weights
# and batch, mostly from cancellation in the deep layers' sums. The JAX model
# rounds each half of an up block's implicit concat separately, the port the
# concat once, so their roundings differ. Bound: each tensor's bf16 gradient
# is at most BF16_GRAD_VS_JAX times as far from the f32 gradient as JAX's
# (1.9 at worst, measured), plus 0.01. Adam's first update is
# lr * g / (|g| + eps), below lr in size, so the parameters differ by < 2 lr.
BF16_LOSS_RTOL, BF16_GRAD_VS_JAX = 1e-3, 2.5
# PHiSeg bf16, one step: Adam's first update is lr * sign(g), so a parameter
# whose bf16 gradient has the other sign than JAX's lies 2 lr (and its own
# rounding) away, the most one step allows; the loss and the running
# statistics are held to BF16_PHISEG_LOSS_RTOL and BF16_PHISEG_STATS_ATOL
# (measured on the CPU: 8.5e-5 relative, 1.5e-5 apart)
BF16_PHISEG_LOSS_RTOL, BF16_PHISEG_STATS_ATOL, BF16_PHISEG_PARAM_LR = 1e-3, 1e-4, 2.01


@pytest.fixture(autouse=True)
def _log_root(tmp_path, monkeypatch):
    """Each port ``Trainer`` here writes its log directory under the
    default ``logs/`` of the working directory: a temporary one."""
    monkeypatch.chdir(tmp_path)


def _batches(n, seed=0):
    """Smooth noise, labelled where it is positive."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((n, 2, 36, 36, 1)).astype(np.float32)
    x = sum(noise[:, :, i:i + 32, j:j + 32] for i in range(5) for j in range(5)) / 5
    return x.astype(np.float32), (x[..., 0] > 0).astype(np.int32)


def _jax_trainer(dtype, tmp_path_factory):
    jcfg = JaxExperimentConfig(**TINY, batch_size=2, dtype=dtype, augmentation_options=jax_options(AUG))
    return JaxTrainer(jcfg, log_dir=str(tmp_path_factory.mktemp(f"jax_{dtype}")), tensorboard=False)


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    return _jax_trainer("float32", tmp_path_factory)


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    return _jax_trainer("bfloat16", tmp_path_factory)


def _jax_phiseg_trainer(dtype, tmp_path_factory):
    """A JAX ``Trainer`` for TINY_PHISEG whose variables are drawn with numpy
    (``tests/test_torch_phiseg.py``) in place of its own init, which would
    take half a minute op by op on the CPU."""
    jcfg = JaxExperimentConfig(**TINY_PHISEG, batch_size=2, dtype=dtype, augmentation_options=jax_options(AUG))
    variables = phiseg_variables(dict(num_filters=TINY_PHISEG["filter_channels"],
                                      latent_levels=TINY_PHISEG["latent_levels"],
                                      image_size=TINY_PHISEG["image_size"]), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        return JaxTrainer(jcfg, log_dir=str(tmp_path_factory.mktemp(f"jax_phiseg_{dtype}")), tensorboard=False)


@pytest.fixture(scope="module")
def jax_phiseg_f32(tmp_path_factory):
    return _jax_phiseg_trainer("float32", tmp_path_factory)


@pytest.fixture(scope="module")
def jax_phiseg_bf16(tmp_path_factory):
    return _jax_phiseg_trainer("bfloat16", tmp_path_factory)


def _port_trainer(dtype, jstate, tiny=TINY):
    tr = Trainer(ExperimentConfig(**tiny, dtype=dtype, augmentation_options=AUG), device="cpu")
    load_jax_params(tr.state.model, jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    return tr


def _z_eps(jtr, jstate, x, y, k_z):
    """The posterior z noise of the JAX step, eps = (z - mu) / sigma of one
    train-mode posterior forward with the step's ``z`` key. The draws depend
    on the key and the shapes alone, so the batch need not be augmented."""
    return [torch.from_numpy(np.array(e)) for e in _jax_z_eps(jtr)(jstate.params, jstate.batch_stats, x, y, k_z)]


@functools.cache
def _jax_step(jtr):
    return jax.jit(jtr._step_fn)


@functools.cache
def _jax_z_eps(jtr):
    @jax.jit
    def z_eps(params, batch_stats, x, y, k_z):
        (z, mu, sigma), _ = jtr.model.apply({"params": params, "batch_stats": batch_stats}, x, y, rngs={"z": k_z},
                                            mutable=["batch_stats"], method=lambda m, x, y: m.posterior(x, y, train=True))
        return [(a - b) / c for a, b, c in zip(z, mu, sigma)]

    return z_eps


def _step_both(jtr, jstate, tr, x, y):
    """One JAX ``_step_fn`` and one port ``train_step`` on JAX's draws;
    returns JAX's new state, both aux dicts and JAX's augmentation key."""
    _, k_aug, k_z = jax.random.split(jstate.rng, 3)  # as _step_fn_inner splits it
    draws = jax_draws(k_aug, x.shape[0], x.shape[1:3], AUG)
    z_eps = _z_eps(jtr, jstate, jnp.asarray(x), jnp.asarray(y), k_z) if jtr.family == "phiseg" else None
    jstate, jaux = _jax_step(jtr)(jstate, jnp.asarray(x), jnp.asarray(y))
    aux = tr.train_step(torch.from_numpy(x), torch.from_numpy(y), draws, z_eps)
    assert set(aux) == set(jaux) and not aux["loss"].requires_grad
    return jstate, jaux, aux, k_aug


def _param_diffs(jstate, tr):
    """max |port - JAX| of every parameter and BatchNorm running statistic."""
    want = state_dict_from_jax(jax.device_get(jstate.params), tr.state.model, jax.device_get(jstate.batch_stats))
    got = tr.state.model.state_dict()
    return {k: (got[k] - want[k]).abs().max().item() for k in want}


def _steps_match_jax_f32(jtr, tiny):
    jstate, lr = jtr.state, jtr.cfg.learning_rate
    tr = _port_trainer("float32", jstate, tiny)
    xs, ys = _batches(F32_STEPS)
    for i in range(F32_STEPS):
        jstate, jaux, aux, _ = _step_both(jtr, jstate, tr, xs[i], ys[i])
        want_loss = float(jaux["loss"])
        assert abs(aux["loss"].item() - want_loss) <= F32_LOSS_RTOL * want_loss, (i, aux["loss"], want_loss)
        assert tr.state.step == int(jstate.step) == i + 1
        assert tr.state.sched.lr.item() == float(jstate.sched.lr)
        np.testing.assert_allclose(tr.state.sched.best.item(), float(jstate.sched.best), rtol=F32_LOSS_RTOL)
        worst = max(_param_diffs(jstate, tr).items(), key=lambda kv: kv[1])
        assert worst[1] <= F32_PARAM_ATOL_LR * lr, (i, worst[0], worst[1] / lr)
    return tr


def test_train_steps_match_jax_f32(jax_f32):
    _steps_match_jax_f32(jax_f32, TINY)


def test_phiseg_train_steps_match_jax_f32(jax_phiseg_f32):
    """Every parameter within 1e-2 lr after each of 3 steps, the biases that
    BatchNorm follows included: their gradient is an exact zero on both sides
    and Adam moves them by the weight decay alone, about lr * sign(p) at the
    first step."""
    tr = _steps_match_jax_f32(jax_phiseg_f32, TINY_PHISEG)
    moved = [n for n, p in tr.state.model.named_parameters() if n.endswith("conv.bias") and not p.grad.any()]
    assert len(moved) > 20


def test_phiseg_train_step_bf16_within_bounds(jax_phiseg_bf16):
    """One bf16 step from the same weights and draws: the loss within
    BF16_PHISEG_LOSS_RTOL, each parameter within 2 lr, the running
    statistics within BF16_PHISEG_STATS_ATOL."""
    jstate, lr = jax_phiseg_bf16.state, jax_phiseg_bf16.cfg.learning_rate
    tr = _port_trainer("bfloat16", jstate, TINY_PHISEG)
    xs, ys = _batches(1)
    jstate, jaux, aux, _ = _step_both(jax_phiseg_bf16, jstate, tr, xs[0], ys[0])
    assert abs(aux["loss"].item() - float(jaux["loss"])) <= BF16_PHISEG_LOSS_RTOL * float(jaux["loss"])
    for name, diff in _param_diffs(jstate, tr).items():
        assert diff <= (BF16_PHISEG_STATS_ATOL if "running" in name else BF16_PHISEG_PARAM_LR * lr), (name, diff)


def test_train_step_bf16_within_bounds(jax_bf16):
    from unet_zoo_tpu.data.augment import augment_batch_2d as jax_augment_batch_2d
    from unet_zoo_tpu.models.registry import get_model as jax_get_model

    params, lr = jax_bf16.state.params, jax_bf16.cfg.learning_rate
    tr = _port_trainer("bfloat16", jax_bf16.state)
    xs, ys = _batches(1)
    jstate, jaux, aux, k_aug = _step_both(jax_bf16, jax_bf16.state, tr, xs[0], ys[0])
    want_loss = float(jaux["loss"])
    assert abs(aux["loss"].item() - want_loss) <= BF16_LOSS_RTOL * want_loss
    assert max(_param_diffs(jstate, tr).values()) < 2 * lr

    # the step's gradients, against JAX's bf16 and the f32 gradient on the same batch
    xa, ya = jax_augment_batch_2d(k_aug, jnp.asarray(xs[0]), jnp.asarray(ys[0]), jax_options(AUG))
    f32_model = jax_get_model("unet", num_classes=2, num_filters=TINY["filter_channels"])

    def grads(model):
        return state_dict_from_jax(jax.device_get(jax.grad(
            lambda p: model.loss(model.apply({"params": p}, xa, train=True), ya)[0])(params)), tr.state.model)

    want_f32, want_bf16 = grads(f32_model), grads(jax_bf16.model)
    for name, p in tr.state.model.named_parameters():
        norm = want_f32[name].norm()
        port_err = ((p.grad - want_f32[name]).norm() / norm).item()
        jax_err = ((want_bf16[name] - want_f32[name]).norm() / norm).item()
        assert port_err <= BF16_GRAD_VS_JAX * jax_err + 0.01, (name, port_err, jax_err)


def test_adam_coupled_l2_matches_optax():
    """Coupled L2: decoupled decay (AdamW) would be lr * wd * |p| ~ 1e-5
    away after one step. The two compute the bias correction 1 - 0.999^t
    in f32, where cancellation leaves ~6e-5 of relative error, each rounding
    it its own way: each update (~lr in size) agrees to 1e-4 of lr, and the
    parameter to that plus 1 ulp of its own size."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = jax_adam_coupled_l2(1e-3, 1e-2)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam_coupled_l2([tp], 1e-3, 1e-2)
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=2.0 ** -23, atol=1e-4 * 1e-3)


def test_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9 * (1 - 1e-5), 0.95, 0.8, 0.85, 0.85, 0.85, 0.85, 0.9, 0.9, 0.9, 0.9]
    kw = dict(factor=0.5, patience=2, min_lr=3e-4)
    js, ts = jax_plateau_init(1e-3), plateau_init(1e-3)
    reductions = 0
    for loss in losses:
        js = jax_plateau_update(js, jnp.float32(loss), **kw)
        lr_before = ts.lr.item()
        ts = plateau_update(ts, torch.tensor(loss), **kw)
        reductions += ts.lr.item() < lr_before
        assert ts.lr.dtype == ts.best.dtype == torch.float32 and ts.num_bad.dtype == torch.int32
        assert ts.lr.item() == float(js.lr) and ts.best.item() == float(js.best)
        assert ts.num_bad.item() == int(js.num_bad)
    assert reductions == 2 and ts.lr.item() == np.float32(3e-4)  # 1e-3 -> 5e-4 -> min_lr


def test_checkpoint_resume_is_exact(tmp_path):
    _resume_is_exact(ExperimentConfig(**TINY, augmentation_options=AUG), tmp_path)


def test_phiseg_checkpoint_resume_is_exact(tmp_path):
    """With BatchNorm's running statistics and the z noise's draws in the state."""
    _resume_is_exact(ExperimentConfig(**TINY_PHISEG, augmentation_options=AUG), tmp_path)


def _resume_is_exact(cfg, tmp_path):
    xs, ys = (torch.from_numpy(a) for a in _batches(3, seed=1))
    straight = Trainer(cfg, device="cpu")
    for i in range(2):
        straight.train_step(xs[i], ys[i])
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, straight.state)
    want = straight.train_step(xs[2], ys[2])

    resumed = Trainer(cfg, device="cpu", seed=99)  # other weights, other draws: all overwritten
    assert restore_checkpoint(path, resumed.state) is resumed.state
    assert resumed.state.step == 2
    got = resumed.train_step(xs[2], ys[2])
    assert torch.equal(got["loss"], want["loss"])
    assert resumed.state.step == straight.state.step == 3
    a, b = resumed.state.model.state_dict(), straight.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for field in ("lr", "best", "num_bad"):
        assert torch.equal(getattr(resumed.state.sched, field), getattr(straight.state.sched, field))
    assert torch.equal(resumed.state.optimizer.param_groups[0]["lr"], straight.state.optimizer.param_groups[0]["lr"])
    assert torch.equal(resumed.state.generator.get_state(), straight.state.generator.get_state())


def test_same_seed_same_trainer():
    cfg = ExperimentConfig(**TINY, augmentation_options=AUG)
    xs, ys = (torch.from_numpy(a) for a in _batches(1, seed=2))
    a, b = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    assert torch.equal(a.train_step(xs[0], ys[0])["loss"], b.train_step(xs[0], ys[0])["loss"])
    assert not torch.equal(Trainer(cfg, device="cpu", seed=1).train_step(xs[0], ys[0])["loss"], a.train_step(xs[0], ys[0])["loss"])


def test_trainer_defaults_to_the_card(monkeypatch):
    """With no device and no card, the entry point raises rather than
    training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(**TINY, augmentation_options=AUG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


def test_unet_experiment_matches_jax():
    got, want = get_experiment("unet"), jax_get_experiment("unet")
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(got.augmentation_options) == {
        k: v for k, v in dataclasses.asdict(want.augmentation_options).items() if k != "warp_precision"}
    kw = got.model_kwargs()
    assert kw["dtype"] is None and kw["num_filters"] == (32, 64, 128, 192) and kw["in_channels"] == 1
    assert dataclasses.replace(got, dtype="bfloat16").model_kwargs()["dtype"] is torch.bfloat16


@pytest.mark.parametrize("name", [*(f"phiseg_7_5_{bs}" for bs in (12, 24, 36, 48, 56)), "phiseg_big"])
def test_phiseg_experiments_match_jax(name):
    """Every field the port carries has the JAX entry's value."""
    got, want = get_experiment(name), jax_get_experiment(name)
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(got.augmentation_options) == {
        k: v for k, v in dataclasses.asdict(want.augmentation_options).items() if k != "warp_precision"}
    kw = got.model_kwargs()
    assert {k: kw[k] for k in ("latent_levels", "zdim", "image_size", "exponential_weighting", "kl_parity")} == {
        k: v for k, v in want.model_kwargs().items() if k in ("latent_levels", "zdim", "image_size",
                                                               "exponential_weighting", "kl_parity")}


def test_registry_names_every_jax_experiment():
    assert sorted(registry.EXPERIMENTS) == sorted(jax_list_experiments())
    assert get_experiment("phiseg_uzh_rev_7_5_192").data_loader == "uzh_prostate"
    with pytest.raises(ValueError, match="unknown experiment"):
        get_experiment("resnet")


@pytest.mark.parametrize("change,error", [
    ({"model": "phiseg3d"}, ValueError),
    ({"model": "resnet"}, ValueError),
    ({"dtype": "float16"}, ValueError),
    ({"image_size": (32, 32, 32)}, NotImplementedError),
    ({"image_size": (4, 32)}, ValueError),
    ({"use_reversible": True, "model": "prob_unet", "image_size": (32, 32, 32)}, NotImplementedError),
    ({"reversible_mode": "remat", "image_size": (32, 32, 32)}, NotImplementedError),
    ({"model": "phiseg", "latent_levels": 5}, ValueError),
    ({"loader": "native", "resize_to": (32, 32)}, ValueError),
    ({"augment_on": "gpu"}, ValueError),
    ({"loader": "mmap"}, ValueError),
    ({"reversible_mode": "revnet"}, ValueError),
])
def test_config_validate_rejects(change, error):
    with pytest.raises(error):
        dataclasses.replace(ExperimentConfig(**TINY), **change).validate()
