"""The port's models, train step and registry in the remat and reversible
memory modes, against the JAX package's, at toy shapes.

A toy U-Net (filters 8/16/16/16, 16x16, batch 2) in "remat" and
"reversible"; a toy RevPHiSeg (filters 4/8/8, 2 latent levels, 32x32, batch
2) in train mode on JAX's z noise, then one ``Trainer.train_step`` of it
against the JAX ``_step_fn`` from the same state and draws. The RevPHiSeg
variables are drawn with numpy (shapes from ``jax.eval_shape`` of the JAX
init). Four JAX graphs are compiled in all: the two U-Net gradients, the
RevPHiSeg gradient (whose outputs give the z noise, eps = (z - mu) / sigma,
which depends on the key and the shapes alone) and the JAX step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_phiseg import _run_jit
from test_torch_reversible import _perturbed
from test_torch_training import AUG, TINY, TINY_PHISEG, _batches, _resume_is_exact
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.models.registry import get_model as jax_get_model
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
from unet_zoo_tpu_torch.models.phiseg import PHiSeg
from unet_zoo_tpu_torch.models.prob_unet import ProbUNet
from unet_zoo_tpu_torch.models.registry import get_model
from unet_zoo_tpu_torch.models.unet import UNet
from unet_zoo_tpu_torch.ops import ReversibleSequence
from unet_zoo_tpu_torch.training import Trainer

UNET_FILTERS = (8, 16, 16, 16)
# f32 U-Net against JAX on the same weights. Remat: the plain model's math,
# every output and gradient within 1e-4 of its max. Reversible: train-mode
# BatchNorm in every block; at 16x16 the coarsest blocks normalise 2x2x2 = 8
# values a channel, which amplifies rounding, so the logits
# are held within 1e-3 of max|ref| and the gradient as one vector within
# REV_UNET_GRAD_L2 relative
F32_OF_MAX = 1e-4
REV_UNET_OF_MAX = 1e-3
REV_UNET_GRAD_L2 = 1e-3
# RevPHiSeg in train mode (measured on the CPU: kl 1.3e-6 relative, the
# gradient 3.7e-6 relative L2, the running statistics 1e-6 of their max,
# the parameters after a step 1.5e-5 lr apart): the loss terms to 1e-5, the
# whole gradient to REV_PHISEG_GRAD_L2 relative (train-mode BatchNorm over
# 8 values a channel at the coarsest level), the running statistics to 1e-5
# of each buffer's max; after one Adam step every parameter within 1e-2 lr
LOSS_RTOL = 1e-5
REV_PHISEG_GRAD_L2 = 1e-4
STATS_OF_MAX = 1e-5
PARAM_ATOL_LR = 1e-2
REV_PHISEG = dict(TINY_PHISEG, experiment_name="tiny_rev_phiseg", use_reversible=True)


@pytest.fixture(autouse=True)
def _log_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _flat(grads):
    return torch.cat([g.flatten() for g in grads])


@functools.cache
def _unet_run(mode):
    """JAX's train-mode logits, loss, gradients and running statistics of
    the toy U-Net in ``mode``, and the port's on the same weights."""
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 1)).astype(np.float32)
    y = (x[..., 0] > 0).astype(np.int32)
    jm = jax_get_model("unet", num_classes=2, num_filters=UNET_FILTERS, reversible_mode=mode)
    variables = _perturbed(jax.device_get(jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), train=True)),
                           seed=2)

    def loss_fn(params):
        logits, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
        return jm.loss(logits, jnp.asarray(y))[0], (logits, mut.get("batch_stats", {}))

    (loss, (logits, stats)), grads = _run_jit(jax.value_and_grad(loss_fn, has_aux=True), variables["params"])
    model = get_model("unet", num_classes=2, num_filters=UNET_FILTERS, reversible_mode=mode, device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"] or None)
    tlogits = model.train()(torch.from_numpy(x))
    tloss, _ = model.loss(tlogits, torch.from_numpy(y))
    tloss.backward()
    want = state_dict_from_jax(jax.device_get(grads), model, jax.device_get(stats) or None)
    return dict(logits=np.asarray(logits), loss=float(loss), want=want, model=model, tlogits=tlogits, tloss=tloss)


@pytest.mark.parametrize("mode", ["remat", "reversible"])
def test_unet_matches_jax(mode):
    r = _unet_run(mode)
    of_max = F32_OF_MAX if mode == "remat" else REV_UNET_OF_MAX
    got, want = r["tlogits"].detach().numpy(), r["logits"]
    assert np.abs(got - want).max() <= of_max * np.abs(want).max()
    np.testing.assert_allclose(r["tloss"].item(), r["loss"], rtol=LOSS_RTOL)
    params = dict(r["model"].named_parameters())
    assert all(p.grad is not None for p in params.values())
    if mode == "remat":
        for name, p in params.items():
            assert (p.grad - r["want"][name]).abs().max() <= F32_OF_MAX * r["want"][name].abs().max(), name
    else:
        got, want = _flat(p.grad for p in params.values()), _flat(r["want"][n] for n in params)
        assert (got - want).norm() <= REV_UNET_GRAD_L2 * want.norm()
        for name, b in r["model"].named_buffers():
            np.testing.assert_allclose(b.numpy(), r["want"][name].numpy(), rtol=STATS_OF_MAX, atol=1e-7,
                                       err_msg=name)
        assert any(".rev.block" in n for n in params) and "down0.rev.initial_conv.conv.weight" in params


def test_unet_modes_share_or_change_the_parameter_tree():
    """remat keeps plain's parameter tree (``convs/conv{i}``), so their
    state_dicts interchange; reversible has its own (``rev``)."""
    plain, remat, rev = (UNet(2, UNET_FILTERS, reversible_mode=m, generator=torch.Generator().manual_seed(0))
                         for m in ("plain", "remat", "reversible"))
    remat.load_state_dict(plain.state_dict())
    assert set(remat.state_dict()) == set(plain.state_dict())
    assert all(".rev." in k or k.startswith("last.") for k in rev.state_dict())
    assert isinstance(rev.down1.rev, ReversibleSequence) and rev.down1.rev.depth == 3


def _rev_phiseg_variables(seed=0):
    """The toy RevPHiSeg's JAX variables, drawn with numpy: conv kernels and
    biases U(+-1/sqrt(fan_in)) (a tenth of that in the 1x1 ``mu`` and
    ``sigma`` heads: the coupling sums grow through the sequences, and the
    full-size heads would put sigma at 1e-7 in places, where the KL's log and
    1/sigma^2 amplify rounding), BatchNorm scales U(0.8, 1.2) and shifts
    U(-0.1, 0.1), running means N(0, 0.2^2) and variances U(0.5, 2)."""
    x = jnp.zeros((1, *REV_PHISEG["image_size"], 1), jnp.float32)
    y = jnp.zeros((1, *REV_PHISEG["image_size"]), jnp.int32)
    jm = JaxPHiSeg(num_classes=2, num_filters=REV_PHISEG["filter_channels"], latent_levels=REV_PHISEG["latent_levels"],
                   image_size=REV_PHISEG["image_size"], reversible_mode="reversible")
    shapes = jax.eval_shape(lambda r: jm.init(r, x, y, train=True),
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


@pytest.fixture(scope="module")
def rev_phiseg(tmp_path_factory):
    """A JAX Trainer of the toy RevPHiSeg on numpy-drawn variables, its step's
    keys and draws, JAX's train-mode gradient on the unaugmented batch and
    the z noise of its step."""
    variables = _rev_phiseg_variables()
    jcfg = JaxExperimentConfig(**REV_PHISEG, batch_size=2, augmentation_options=jax_options(AUG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        jtr = JaxTrainer(jcfg, log_dir=str(tmp_path_factory.mktemp("jax_rev_phiseg")), tensorboard=False)
    xs, ys = _batches(1, seed=3)
    x, y = xs[0], ys[0]
    _, k_aug, k_z = jax.random.split(jtr.state.rng, 3)

    def loss_fn(params, x, y, key):
        out, mut = jtr.model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, y, train=True,
                                   rngs={"z": key}, mutable=["batch_stats"])
        loss, aux = jtr.model.loss(out, y, params)
        return loss, (aux, out, mut["batch_stats"])

    (_, (aux, out, stats)), grads = _run_jit(jax.value_and_grad(loss_fn, has_aux=True), variables["params"],
                                             jnp.asarray(x), jnp.asarray(y), k_z)
    eps = [torch.from_numpy(np.array((z - m) / s)) for z, m, s in zip(out["post_z"], out["post_mu"], out["post_sigma"])]
    return dict(jtr=jtr, variables=variables, x=x, y=y, k_aug=k_aug, eps=eps, aux=jax.device_get(aux),
                grads=jax.device_get(grads), stats=jax.device_get(stats))


def test_rev_phiseg_train_mode_matches_jax(rev_phiseg):
    r = rev_phiseg
    kw = ExperimentConfig(**REV_PHISEG).model_kwargs()
    model = load_jax_params(get_model("phiseg", **kw, device="cpu"), r["variables"]["params"],
                            r["variables"]["batch_stats"]).train()
    assert isinstance(model.posterior.down1.rev, ReversibleSequence)
    assert model.posterior.down1.rev.depth == 3 and model.likelihood.embed0.depth == 2
    assert model.likelihood.incres0_0.remat  # the resolution-increase stages: plain parameters, under remat
    y = torch.from_numpy(r["y"])
    loss, aux = model.loss(model(torch.from_numpy(r["x"]), y, post_eps=r["eps"]), y)
    loss.backward()
    for key in ("loss", "kl", "recon"):
        np.testing.assert_allclose(aux[key].item(), float(r["aux"][key]), rtol=LOSS_RTOL, err_msg=key)
    want = state_dict_from_jax(r["grads"], model, r["stats"])
    params = dict(model.named_parameters())
    got, ref = _flat(p.grad for p in params.values()), _flat(want[n] for n in params)
    assert (got - ref).norm() <= REV_PHISEG_GRAD_L2 * ref.norm()
    zero = [n for n in params if n.endswith("_bias") or (n.endswith("conv.bias") and "head" not in n)]
    assert zero and all(not params[n].grad.any() and not want[n].any() for n in zero)
    for name, b in model.named_buffers():
        assert (b - want[name]).abs().max() <= STATS_OF_MAX * want[name].abs().max(), name


def test_rev_phiseg_train_step_matches_jax(rev_phiseg):
    """One ``Trainer.train_step`` against the JAX ``_step_fn`` from the same
    state, augmentation draws and z noise: the loss, every parameter after
    Adam's update and the running statistics."""
    r = rev_phiseg
    jtr, lr = r["jtr"], r["jtr"].cfg.learning_rate
    tr = Trainer(ExperimentConfig(**REV_PHISEG, augmentation_options=AUG), device="cpu")
    load_jax_params(tr.state.model, r["variables"]["params"], r["variables"]["batch_stats"])
    draws = jax_draws(r["k_aug"], 2, REV_PHISEG["image_size"], AUG)
    jstate, jaux = _run_jit(jtr._step_fn, jtr.state, jnp.asarray(r["x"]), jnp.asarray(r["y"]))
    aux = tr.train_step(torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), draws, r["eps"])
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]), rtol=LOSS_RTOL)
    want = state_dict_from_jax(jax.device_get(jstate.params), tr.state.model, jax.device_get(jstate.batch_stats))
    for name, v in tr.state.model.state_dict().items():
        if "_mean" in name or "_var" in name or "running" in name:
            assert (v - want[name]).abs().max() <= STATS_OF_MAX * want[name].abs().max(), name
        else:
            assert (v - want[name]).abs().max() <= PARAM_ATOL_LR * lr, name


@pytest.mark.parametrize("name", ["reversible_unet", *(f"phiseg_rev_7_5_{bs}" for bs in (12, 24, 36, 48, 56, 60, 64)),
                                  "phiseg_big_reversible"])
def test_reversible_experiments_match_jax(name):
    got, want = get_experiment(name), jax_get_experiment(name)
    for field in dataclasses.fields(got):
        if field.name != "augmentation_options":
            assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.effective_reversible_mode == "reversible"
    assert got.model_kwargs()["reversible_mode"] == want.model_kwargs()["reversible_mode"] == "reversible"


@pytest.mark.parametrize("name,cls", [("reversible_unet", UNet), ("phiseg_rev_7_5_12", PHiSeg),
                                      ("prob_unet_reversible", ProbUNet)])
def test_reversible_experiments_build(name, cls):
    cfg = get_experiment(name)
    model = get_model(cfg.model, **cfg.model_kwargs(), device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, cls)
    assert any(isinstance(m, ReversibleSequence) for m in model.modules())


@pytest.mark.parametrize("name", ["phiseg_uzh_rev_7_5_256", "phiseg_uzh_rev_7_5_192", "phiseg_uzh_rev_7_5_224"])
def test_unported_reversible_experiments_raise(name):
    """The UZH reversible experiments build RevPHiSeg, 3 classes, with ``ReversibleSequence``."""
    cfg = get_experiment(name)
    model = get_model(cfg.model, **cfg.model_kwargs(), device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(model, PHiSeg) and cfg.effective_reversible_mode == "reversible" and cfg.n_classes == 3
    assert any(isinstance(m, ReversibleSequence) for m in model.modules())


@pytest.mark.parametrize("model", ["unet", "phiseg", "prob_unet"])
@pytest.mark.parametrize("mode", ["remat", "reversible"])
def test_config_accepts_the_memory_modes(model, mode):
    base = {"unet": TINY, "phiseg": TINY_PHISEG, "prob_unet": {**TINY, "model": "prob_unet"}}[model]
    cfg = ExperimentConfig(**base, reversible_mode=mode)
    cfg.validate()
    assert cfg.model_kwargs()["reversible_mode"] == mode
    with pytest.raises(ValueError, match="reversible_mode"):
        dataclasses.replace(cfg, reversible_mode="revnet").validate()


@pytest.mark.parametrize("cfg", [dict(REV_PHISEG), dict(TINY, reversible_mode="remat"), dict(TINY, use_reversible=True)],
                         ids=["rev_phiseg", "remat_unet", "rev_unet"])
def test_memory_mode_checkpoint_resume_is_exact(cfg, tmp_path):
    """A trainer in a memory mode takes steps, and a checkpoint (the
    reversible blocks' parameters, running statistics and Adam moments)
    resumes to the same step."""
    _resume_is_exact(ExperimentConfig(**cfg, augmentation_options=AUG), tmp_path)


def test_f32_chains_on_the_card_take_the_kernel():
    """The conv chain's route: on CUDA the hand-written kernel in both
    dtypes (float32 on its 3xTF32 tensor-core kernel, never a library conv),
    on the CPU the plain version; ``Trainer`` reports it."""
    from unet_zoo_tpu_torch.ops import conv
    from unet_zoo_tpu_torch.ops.pallas.conv_chain import fused_conv_chain_reference

    assert conv.chain_route(torch.bfloat16, "cuda:0") == "conv3x3_bf16_wgmma"
    assert conv.chain_route(torch.float32, "cuda") == "conv3x3_f32_3xtf32_wgmma"
    assert conv.chain_route(torch.float32, "cpu") == conv.chain_route(torch.bfloat16, "cpu") == "plain"
    assert Trainer(ExperimentConfig(**TINY), device="cpu").chain_route == "plain"
    seq = conv.ConvSeq(3, 4, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 5, 6, 3), generator=torch.Generator().manual_seed(1))
    convs = [m.conv for m in seq.children()]
    assert torch.equal(seq(x), fused_conv_chain_reference(x, [c.weight for c in convs], [c.bias for c in convs]))
