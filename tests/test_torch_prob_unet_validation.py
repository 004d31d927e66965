"""Where the Probabilistic U-Net's eval-mode loss overflows, in the JAX
package and in the port alike.

The registered ``prob_unet`` and ``prob_unet_reversible`` at full width
(7 levels, 32-192 filters, 128x128), float32 on the CPU, on JAX's own
initialisation carried across with ``unet_zoo_tpu_torch.bridge``:

- trained for a few steps on synthetic LIDC data with JAX's augmentation
  draws and z noise injected, each package on its own trajectory: the
  BN-free trunk's features grow ~1e5-fold from step 4 to step 12 at lr
  1e-3, and eval-mode BatchNorm in the posterior net and ``fcomb``, on running
  statistics that lag them, lets sigma and the logits overflow, so a
  validation's KL turns NaN within 8 steps in both packages;
- untrained, the reversible model's coupling blocks, with he_normal
  kernels and BatchNorm on its initial statistics, grow the features
  ~1e10-fold, and the eval-mode loss is NaN in both packages.

So a NaN validation early in training is the model's, not the port's.
Run as a script (``PYTHONPATH=. python tests/test_torch_prob_unet_validation.py
[--steps N] [--batch B]``) to print each package's readings every 4 steps.
"""

import argparse
import dataclasses
import math
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_prob_unet import _jax_normal
from test_torch_training import F32_LOSS_RTOL
from unet_zoo_tpu.experiments import get_experiment as jax_get_experiment
from unet_zoo_tpu.models.prob_unet import ProbUNet as JaxProbUNet
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import load_jax_params
from unet_zoo_tpu_torch.data import synthetic
from unet_zoo_tpu_torch.experiments import get_experiment
from unet_zoo_tpu_torch.training import Trainer

BATCH, VAL_IMAGES, READ_EVERY = 2, 4, 4
# free f32 trajectories at batch 2 (the CPU, 8 threads): the validation's
# loss terms are finite after 4 steps on both sides (KL 2.6e3 JAX, 2.9e3
# port; posterior sigma 7.8e3, 7.9e3); after 8 the posterior's sigma
# reaches 1.3e35 (JAX) and 5.8e34 (port), so KL is NaN on both; after 12
# every term is NaN on both and sigma inf
STEPS = 12
# the trunk's features from the first reading to the last grow by more than
# this on both sides (measured 1.4e5 JAX, 8.9e4 port)
FEATURE_GROWTH = 1e3
# untrained reversible model, eval mode: max|features| over this on both
# sides, the coupling blocks' growth (measured 4.84e9 on both)
REV_FEATURES = 1e8


def _jit_init(mp):
    """JAX's ``ProbUNet.init`` compiled (op by op it takes ~30 s at full
    width); the same variables."""
    init = JaxProbUNet.init
    mp.setattr(JaxProbUNet, "init", lambda self, rngs, *args, train: jax.jit(
        lambda r, *a: init(self, r, *a, train=train))(rngs, *args))


def _batches(splits, rng, split, n):
    """n images of ``split`` with one annotator's mask each."""
    d = splits[split]
    i, a = rng.choice(len(d["images"]), n), rng.integers(0, d["labels"].shape[-1], n)
    return d["images"][i][..., None].astype(np.float32), d["labels"][i, :, :, a].astype(np.int32)


def _readings(out, aux):
    return {"loss": float(aux["loss"]), "kl": float(aux["kl"]), "recon": float(aux["recon"]),
            "features": float(np.abs(np.asarray(out["features"])).max()),
            "post_sigma": float(np.asarray(out["post_sigma"]).max())}


def free_trajectories(steps=STEPS, batch=BATCH, report=None):
    """``steps`` f32 steps of JAX's ``prob_unet`` Trainer and of the port's
    from the same variables, images, augmentation draws and z noise, each on
    its own trajectory; every READ_EVERY steps the eval-mode loss of
    VAL_IMAGES validation images on the same z on both sides. Returns the
    per-step train losses and the readings, {"jax": [...], "port": [...]}."""
    cfg = dataclasses.replace(get_experiment("prob_unet"), batch_size=batch)
    jcfg = dataclasses.replace(jax_get_experiment("prob_unet"), batch_size=batch,
                               augmentation_options=jax_options(cfg.augmentation_options))
    with pytest.MonkeyPatch.context() as mp:
        _jit_init(mp)
        jtr = JaxTrainer(jcfg, log_dir=tempfile.mkdtemp(), tensorboard=False)
    tr = Trainer(cfg, device="cpu", log_dir=tempfile.mkdtemp(), tensorboard=False)
    load_jax_params(tr.state.model, jax.device_get(jtr.state.params), jax.device_get(jtr.state.batch_stats))
    splits = synthetic.lidc_splits((32, VAL_IMAGES, 0), cfg.image_size[0], seed=0)
    rng = np.random.default_rng(0)
    vx, vy = _batches(splits, rng, "val", VAL_IMAGES)
    jm, model = jtr.model, tr.state.model

    @jax.jit
    def jax_eval(state, key):
        out = jm.apply({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(vx),
                       jnp.asarray(vy), train=False, rngs={"z": key})
        return out, jm.loss(out, jnp.asarray(vy), state.params)[1]

    def port_eval(eps):
        model.eval()
        with torch.no_grad():
            out = model(torch.from_numpy(vx), torch.from_numpy(vy), post_eps=eps)
            aux = model.loss(out, torch.from_numpy(vy))[1]
        model.train()
        return {k: v.numpy() for k, v in out.items()}, {k: v.item() for k, v in aux.items()}

    step = jax.jit(jtr._step_fn)
    jstate, size = jtr.state, cfg.image_size
    result = {"losses": {"jax": [], "port": []}, "readings": {"jax": [], "port": []}}
    for i in range(steps):
        x, y = _batches(splits, rng, "train", batch)
        _, k_aug, k_z = jax.random.split(jstate.rng, 3)  # as the JAX step splits it
        draws = jax_draws(k_aug, batch, size, cfg.augmentation_options)
        z_eps = torch.from_numpy(_jax_normal(k_z, (batch, cfg.latent_dim)))
        jstate, jaux = step(jstate, jnp.asarray(x), jnp.asarray(y))
        aux = tr.train_step(torch.from_numpy(x), torch.from_numpy(y), draws, z_eps)
        result["losses"]["jax"].append(float(jaux["loss"]))
        result["losses"]["port"].append(aux["loss"].item())
        if (i + 1) % READ_EVERY:
            continue
        key = jax.random.PRNGKey(100 + i)
        eps = torch.from_numpy(_jax_normal(key, (VAL_IMAGES, cfg.latent_dim)))
        for side, reading in (("jax", _readings(*jax.device_get(jax_eval(jstate, key)))),
                              ("port", _readings(*port_eval(eps)))):
            result["readings"][side].append(reading)
            if report:
                report(f"step {i + 1} {side}: train loss {result['losses'][side][-1]:.6g}, validation {reading}")
    return result


def untrained_reversible(report=None):
    """The untrained ``prob_unet_reversible``'s eval-mode forward and loss on
    one image, in both packages on JAX's initialisation and the same z."""
    cfg = get_experiment("prob_unet_reversible")
    jcfg = jax_get_experiment("prob_unet_reversible")
    jm = JaxProbUNet(**{k: v for k, v in jcfg.model_kwargs().items() if k != "dtype"})
    splits = synthetic.lidc_splits((0, 1, 0), cfg.image_size[0], seed=1)
    x, y = _batches(splits, np.random.default_rng(1), "val", 1)
    key = jax.random.PRNGKey(3)
    with pytest.MonkeyPatch.context() as mp:
        _jit_init(mp)
        variables = jm.init({"params": jax.random.PRNGKey(cfg.seed), "z": key}, jnp.asarray(x), jnp.asarray(y),
                            train=True)

    @jax.jit
    def jax_eval(v):
        out = jm.apply(v, jnp.asarray(x), jnp.asarray(y), train=False, rngs={"z": key})
        return out, jm.loss(out, jnp.asarray(y), v["params"])[1]

    model = Trainer(cfg, device="cpu", log_dir=tempfile.mkdtemp(), tensorboard=False).state.model.eval()
    load_jax_params(model, jax.device_get(variables["params"]), jax.device_get(variables["batch_stats"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(y),
                    post_eps=torch.from_numpy(_jax_normal(key, (1, cfg.latent_dim))))
        aux = model.loss(out, torch.from_numpy(y))[1]
    readings = {"jax": _readings(*jax.device_get(jax_eval(variables))),
                "port": _readings({k: v.numpy() for k, v in out.items()}, {k: v.item() for k, v in aux.items()})}
    if report:
        report(f"untrained prob_unet_reversible, eval mode: {readings}")
    return readings


def test_validation_overflows_within_steps_as_in_jax():
    """Free f32 trajectories from JAX's initialisation: the first step's loss
    within F32_LOSS_RTOL, every train loss finite on both sides; the
    validation's loss terms finite after 4 steps on both and KL not finite
    after STEPS on both, the features grown by over FEATURE_GROWTH on both."""
    r = free_trajectories()
    losses, readings = r["losses"], r["readings"]
    assert abs(losses["port"][0] - losses["jax"][0]) <= F32_LOSS_RTOL * losses["jax"][0]
    assert all(math.isfinite(v) for side in losses.values() for v in side), losses
    for side in ("jax", "port"):
        first, last = readings[side][0], readings[side][-1]
        assert all(math.isfinite(first[k]) for k in ("loss", "kl", "recon")), (side, first)
        assert not math.isfinite(last["kl"]), (side, last)
        assert last["features"] > FEATURE_GROWTH * first["features"], (side, first, last)


def test_untrained_reversible_eval_loss_is_nan_as_in_jax():
    """The untrained reversible model in eval mode: features over
    REV_FEATURES and a NaN loss, in both packages."""
    readings = untrained_reversible()
    for side, reading in readings.items():
        assert reading["features"] > REV_FEATURES and math.isnan(reading["loss"]), (side, reading)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args()
    free_trajectories(args.steps, args.batch, report=print)
    untrained_reversible(report=print)
    sys.exit(0)
