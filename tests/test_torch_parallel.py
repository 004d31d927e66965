"""Data parallelism of the PyTorch port (``unet_zoo_tpu_torch.parallel``,
``Trainer(mesh=...)``, the CLIs' mesh flags) against the one-process port
and the JAX package, on the CPU.

The two-process cases run in one spawn of two processes
(``tests/torch_dp_worker.py``, gloo over 127.0.0.1, a time limit), started
once for the module while the JAX package's mesh step compiles here:

* the cross-rank ``BatchNorm`` against the JAX ``BatchNorm(axis_name=...)``
  under ``jax.vmap`` on the same two shards;
* 3 steps of the toy U-Net, PHiSeg (plain and reversible) and ProbUNet with
  device augmentation, against the one-process step on the global batch,
  and at world 1 (the Trainer without a mesh) bit for bit against the step
  in which the model draws its own z noise;
* one toy PHiSeg step on the JAX draws against the JAX
  ``Trainer(mesh=make_mesh(2))._train_step`` on the conftest's virtual CPU
  devices;
* ``Trainer.train`` with validations on process 0 alone.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_draws, jax_options
from test_torch_phiseg import LOSS_RTOL, TRAIN_GRAD_L2
from test_torch_phiseg import _variables as phiseg_variables
from test_torch_training import F32_PARAM_ATOL_LR, _z_eps
from torch_dp_worker import AUG, CONFIGS, MAIN_FILES, STEPS, TRAIN, TRAIN_SPLITS, state_arrays
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.ops.norm import BatchNorm as JaxBatchNorm
from unet_zoo_tpu.parallel import make_mesh as jax_make_mesh
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch.bridge import state_dict_from_jax
from unet_zoo_tpu_torch.data import LIDCData, synthetic
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.parallel import (
    barrier,
    batch_spec,
    host_to_global,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
    shard_label_spec,
)
from unet_zoo_tpu_torch.parallel import mesh as mesh_module
from unet_zoo_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads_,
    all_reduce_mean_,
    local_mesh,
    mean_over_processes,
    process_index,
)
from unet_zoo_tpu_torch.parallel import space as space_lib
from unet_zoo_tpu_torch.parallel.space import constrain, space_sharding
from unet_zoo_tpu_torch.training import Trainer, cli, restore_checkpoint

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
SPAWN_TIMEOUT = 240  # seconds for the two processes' whole run
CPU = torch.device("cpu")
# BatchNorm, f32: the port's per-rank sums all-reduced against JAX's pmean
# of per-shard means, the same values summed in another order
BN_OF_MAX = 1e-5
# 2 processes against 1, f32, each step from the same state (the one-process
# step restores the two processes' checkpoint of the step before): the
# gradient is the same mean of per-image terms summed in another order (two
# shards' BatchNorm sums, the all-reduce), so the loss within DP_LOSS_RTOL,
# the gradient within DP_GRAD_L2 (relative L2), the running statistics
# within DP_STATS_OF_MAX of each buffer's max|value|, and each parameter
# within DP_PARAM_ATOL_LR lr, except an entry whose gradient is rounding
# (within ROUNDING_OF_MAX of its tensor's max|g|: the reversible backward
# reconstructs its inputs from rounded outputs): Adam's first update,
# lr * sign(g), may give it the other sign, ROUNDING_FLIP_LR lr away, in at
# most FLIP_SHARE of all entries (measured on the CPU: loss 3.1e-6,
# statistics 6.7e-6 of their max; in the reversible PHiSeg's first step 2
# of 17396 entries flipped, their |g| 3.4e-4 and 3.0e-5 of their tensor's
# max; every other entry within 1e-3 lr)
DP_LOSS_RTOL, DP_GRAD_L2, DP_STATS_OF_MAX = 1e-4, 1e-4, 1e-4
DP_PARAM_ATOL_LR, ROUNDING_OF_MAX, ROUNDING_FLIP_LR, FLIP_SHARE = 2e-2, 1e-3, 2.01, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batches(n: int, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, batch, 32, 32, 1)).astype(np.float32)
    return x, (x[..., 0] > 0).astype(np.int64)


def _jax_phiseg_mesh_trainer(tmp_path):
    """The JAX ``Trainer`` of the toy PHiSeg on a 2-device mesh, its
    variables drawn with numpy (its own init would take half a minute op
    by op)."""
    cfg = CONFIGS["phiseg"]
    jcfg = JaxExperimentConfig(**{**cfg, "augmentation_options": jax_options(AUG)})
    variables = phiseg_variables(dict(num_filters=cfg["filter_channels"], latent_levels=cfg["latent_levels"],
                                      image_size=cfg["image_size"]), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        return JaxTrainer(jcfg, log_dir=str(tmp_path / "jax_mesh"), tensorboard=False, mesh=jax_make_mesh(2))


def _jax_bn(x: np.ndarray, weight: np.ndarray, bias: np.ndarray, cot: np.ndarray) -> dict:
    """The JAX ``BatchNorm(axis_name="data")`` in train mode on the two
    shards of x under ``jax.vmap``: outputs, running statistics, and the
    gradients of sum(y * cot) for x and the parameters."""
    bn = JaxBatchNorm(axis_name="data")
    c = x.shape[-1]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def run(params, xs):
        def one(shard):
            y, mut = bn.apply({"params": params, "batch_stats": stats}, shard, use_running_average=False,
                              mutable=["batch_stats"])
            return y, mut["batch_stats"]

        return jax.vmap(one, axis_name="data")(xs)

    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    shards = jnp.asarray(x).reshape(2, -1, *x.shape[1:])
    y, new_stats = run(params, shards)
    gp, gx = jax.grad(lambda p, xs: jnp.sum(run(p, xs)[0] * cot.reshape(shards.shape)), argnums=(0, 1))(
        params, shards)
    return {"y": np.asarray(y).reshape(x.shape), "x_grad": np.asarray(gx).reshape(x.shape),
            "weight_grad": np.asarray(gp["scale"]), "bias_grad": np.asarray(gp["bias"]),
            "mean": np.asarray(new_stats["mean"][0]), "var": np.asarray(new_stats["var"][0])}


def _jax_grads_from_adam(jstate, params0) -> dict:
    """JAX's gradient of its first step, from Adam's first moment after it:
    mu = (1 - b1) (g + wd p) for coupled L2 from zero moments."""
    cfg = CONFIGS["phiseg"]
    wd = JaxExperimentConfig(**{**cfg, "augmentation_options": None}).weight_decay
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
             if hasattr(s, "mu")]
    return jax.tree_util.tree_map(lambda m, p: np.asarray(m) / (1 - 0.9) - wd * np.asarray(p), jax.device_get(mu),
                                  params0)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two processes' results (``ranks``) beside what they are held to:
    the one-process port runs, the JAX BatchNorm and the JAX mesh step."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    bn_in = {"x": rng.standard_normal((4, 5, 6, 3)).astype(np.float32) * 2 + 1,
             "weight": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "bias": rng.standard_normal(3).astype(np.float32),
             "cot": rng.standard_normal((4, 5, 6, 3)).astype(np.float32)}
    xs, ys = _global_batches(STEPS, CONFIGS["unet"]["batch_size"], seed=1)

    # the JAX mesh step's inputs and draws, and the port's weights for it
    jtr = _jax_phiseg_mesh_trainer(tmp)
    jstate = jtr.state
    jx, jy = _global_batches(1, CONFIGS["phiseg"]["batch_size"], seed=2)
    jx, jy = jx[0], jy[0].astype(np.int32)
    _, k_aug, k_z = jax.random.split(jstate.rng, 3)
    draws = jax_draws(k_aug, jx.shape[0], jx.shape[1:3], AUG)
    z_eps = _z_eps(jtr, jstate, jnp.asarray(jx), jnp.asarray(jy), k_z)
    port = Trainer(ExperimentConfig(**CONFIGS["phiseg"]), device="cpu", tensorboard=False, log_dir=str(tmp / "p"))
    params0, stats0 = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    weights = state_dict_from_jax(params0, port.state.model, stats0)

    inputs = {**{f"bn.{k}": v for k, v in bn_in.items()}, "steps.x": xs, "steps.y": ys,
              **{f"injected.w.{k}": v.numpy() for k, v in weights.items()},
              **{f"injected.aug.{f}": getattr(draws, f).numpy() for f in draws._fields},
              **{f"injected.z.{i}": e.numpy() for i, e in enumerate(z_eps)},
              "injected.x": jx, "injected.y": jy.astype(np.int64)}
    np.savez(tmp / "in.npz", **inputs)
    port_ = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", port_, str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        # meanwhile: the JAX BatchNorm, the JAX mesh step (it donates its
        # state) and the one-process training run
        bn_jax = _jax_bn(**bn_in)
        jstate1, jaux = jtr._train_step(jstate, jnp.asarray(jx), jnp.asarray(jy))
        jax_step = {"loss": float(jaux["loss"]),
                    "state": state_dict_from_jax(jax.device_get(jstate1.params), port.state.model,
                                                 jax.device_get(jstate1.batch_stats)),
                    "grads": {k: v for k, v in state_dict_from_jax(_jax_grads_from_adam(jstate1, params0),
                                                                   port.state.model, stats0).items()
                              if "running" not in k}}
        data = LIDCData(synthetic.lidc_splits(TRAIN_SPLITS, 32, seed=0), seed=0)
        tr = Trainer(ExperimentConfig(**TRAIN), device="cpu", tensorboard=False, log_dir=str(tmp / "train_one"))
        train_one = {"loss": tr.train(data)["loss"].item(), **state_arrays(tr)}
        tr.close()
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"DONE {r}" in out, f"process {r}:\n{out}"
        one = {name: _one_process_steps(cfg, xs, ys, tmp, name) for name, cfg in CONFIGS.items()}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(2)]
    return {"tmp": tmp, "ranks": ranks, "bn_jax": bn_jax, "one": one, "jax_step": jax_step,
            "train_one": train_one, "port_lr": port.cfg.learning_rate}


def _one_process_steps(cfg: dict, xs, ys, tmp: Path, name: str) -> list:
    """The one-process step on each global batch, each from the two
    processes' state before it: the state after it, and its gradient."""
    tr = Trainer(ExperimentConfig(**cfg), device="cpu", tensorboard=False, log_dir=str(tmp / f"one_{name}"))
    states = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        if i:
            restore_checkpoint(str(tmp / f"{name}.{i - 1}.pt"), tr.state)
        aux = tr.train_step(torch.from_numpy(x), torch.from_numpy(y))
        grads = {f"grad.{n}": p.grad.numpy().copy() for n, p in tr.state.model.named_parameters()}
        states.append({"loss": aux["loss"].item(), **state_arrays(tr), **grads})
    return states


def _is_stat(name: str) -> bool:
    return name.startswith(("running", "sched.", "generator")) or ".running_" in name or \
        name.endswith(("_mean", "_var"))


def _within(got: dict, want: dict, lr: float, label: str) -> None:
    """``got`` against ``want`` (a state after a step, with its gradient):
    the gradient and the running statistics within their gates, and every
    parameter within DP_PARAM_ATOL_LR lr but the few whose gradient cancels
    to rounding (see DP_PARAM_ATOL_LR)."""
    names = sorted(k[len("grad."):] for k in want if k.startswith("grad."))
    g = np.concatenate([got[f"grad.{n}"].ravel() for n in names]).astype(np.float64)
    w = np.concatenate([want[f"grad.{n}"].ravel() for n in names]).astype(np.float64)
    assert np.linalg.norm(g - w) <= DP_GRAD_L2 * np.linalg.norm(w), (label, np.linalg.norm(g - w) / np.linalg.norm(w))
    flipped = 0
    for k, v in want.items():
        if k in ("loss", "generator") or k.startswith(("sched.", "grad.")):
            continue
        diff = np.abs(got[k] - v)
        if _is_stat(k):
            assert diff.max() <= DP_STATS_OF_MAX * np.abs(v).max(), (label, k, diff.max())
            continue
        grad = np.abs(want[f"grad.{k}"])
        off = diff > DP_PARAM_ATOL_LR * lr
        assert not (off & (grad > ROUNDING_OF_MAX * grad.max())).any(), (label, k, diff[off].max() / lr)
        assert diff.max() <= ROUNDING_FLIP_LR * lr, (label, k, diff.max() / lr)
        flipped += int(off.sum())
    assert flipped <= FLIP_SHARE * len(g), (label, flipped)


# the mesh, its shards and the space axis


def test_make_mesh_alone_and_shards():
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.space, mesh.rank, mesh.world, mesh.group, mesh.device) == (1, 1, 0, 1, None, CPU)
    assert process_index() == 0
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, device="cpu")
    second = Mesh(data=2, space=1, rank=1, world=2, group=None, device=CPU)
    x = np.arange(8 * 3).reshape(8, 3)
    assert batch_spec(second, 8) == shard_label_spec(second, 8) == slice(4, 8)
    np.testing.assert_array_equal(shard_batch(second, x), x[4:])
    assert torch.equal(host_to_global(second, x), torch.from_numpy(x[4:]))
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_batch(second, x[:5])
    barrier("alone")  # a no-op in one process
    assert replicated(mesh, [torch.ones(3)])


def test_local_mesh_is_one_process_whose_collectives_return_at_once():
    mesh = local_mesh("cpu")
    assert (mesh.data, mesh.space, mesh.rank, mesh.world, mesh.group, mesh.device) == (1, 1, 0, 1, None, CPU)
    t = torch.tensor([1.5, -2.0])
    assert all_reduce_mean_(mesh, t) is t and torch.equal(t, torch.tensor([1.5, -2.0]))
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = grad = torch.full((3,), 0.25)
    all_reduce_grads_(mesh, [p])
    assert p.grad is grad and torch.equal(grad, torch.full((3,), 0.25))
    loss = torch.tensor(0.5, requires_grad=True) * 2
    means = mean_over_processes(mesh, {"loss": loss})
    assert not means["loss"].requires_grad and means["loss"].item() == 1.0


def test_trainer_without_a_mesh_holds_a_local_one(tmp_path):
    tr = Trainer(ExperimentConfig(**CONFIGS["unet"]), device="cpu", tensorboard=False, log_dir=str(tmp_path))
    assert tr.mesh == local_mesh("cpu") and tr.device == CPU and tr.is_main
    tr.close()


@pytest.mark.parametrize("device, backend, cards, want", [
    ("cpu", None, 0, "gloo"),
    ("cuda", None, 8, "nccl"),
    ("cuda", None, 4, "nccl"),  # one node of two: 8 processes, 4 cards a host
    ("cuda", None, 1, "nccl"),  # one card made visible to each process
    ("cuda", "gloo", 1, "gloo"),  # processes sharing one card ask for gloo
])
def test_init_distributed_backend(monkeypatch, device, backend, cards, want):
    """NCCL for every group on the cards, whatever this host sees of them,
    unless gloo is asked for; gloo on the CPU."""
    seen = {}
    monkeypatch.setattr(mesh_module.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh_module.dist, "init_process_group", lambda b, **kw: seen.update(backend=b, **kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert init_distributed("127.0.0.1:29500", 8, 5, device=device, backend=backend)
    assert seen["backend"] == want and (seen["world_size"], seen["rank"]) == (8, 5)
    assert seen["init_method"] == "tcp://127.0.0.1:29500" and seen["timeout"] == mesh_module.TIMEOUT


def test_init_distributed_alone_and_incomplete():
    assert init_distributed(device="cpu") is False
    with pytest.raises(ValueError, match="multi-process launch needs"):
        init_distributed(num_processes=2, process_id=0, device="cpu")


def test_space_sharding_is_a_noop_at_space_1_and_raises_above():
    """A no-op at space 1 (no ``Space`` is active, ``constrain`` is the
    identity); active above it, where ``constrain`` keeps this process's
    rows of an activation whose global height splits evenly; a one-process
    run raises for a space axis of 2, which takes 2 processes."""
    x = torch.arange(2 * 8 * 4 * 1, dtype=torch.float32).reshape(2, 8, 4, 1)
    for mesh in (None, make_mesh(device="cpu")):
        with space_sharding(mesh) as sp:
            assert sp is None and space_lib.current() is None and constrain(x) is x
    second = Mesh(data=1, space=2, rank=1, world=2, group=None, device=CPU, space_group=object())
    with space_sharding(second) as sp:
        assert space_lib.current() is sp and (sp.size, sp.index, sp.up, sp.down) == (2, 1, 0, None)
        assert torch.equal(sp.shard(x), x[:, 4:])  # records the pyramid 8x4 -> 4x2 -> 2x1 -> 1x1
        assert torch.equal(constrain(x), x[:, 4:]) and constrain(x[:, 4:]).shape == (2, 4, 4, 1)
        with pytest.raises(ValueError, match="rank 4 or 5"):
            constrain(x[..., 0])
    assert space_lib.current() is None
    with pytest.raises(ValueError, match="needs 2 processes|does not divide"):
        make_mesh(1, space=2, device="cpu")


def test_trainer_rejects_an_indivisible_batch(tmp_path):
    cfg = ExperimentConfig(**{**CONFIGS["unet"], "batch_size": 5})
    with pytest.raises(ValueError, match="does not split evenly"):
        Trainer(cfg, tensorboard=False, log_dir=str(tmp_path),
                mesh=Mesh(data=2, space=1, rank=0, world=2, group=None, device=CPU))


def _cli_args(*flags):
    p = argparse.ArgumentParser()
    cli._common_args(p)
    return p.parse_args(["exp", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags, message", [
    (("--mesh", "data=2,depth=1"), "bad component"),
    (("--mesh", "data"), "bad component"),
    (("--mesh", "data=two"), "bad component"),
    (("--space", "2"), "takes 2 processes.*--num-processes 2"),
    (("--mesh", "data=1,space=2"), "takes 2 processes.*--num-processes 2"),
    (("--mesh", "space=1", "--space", "2"), "contradicts"),
    (("--mesh", "data=2"), "--num-processes 2"),
])
def test_cli_mesh_flags_fail_with_a_message(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.make_cli_mesh(_cli_args(*flags), batch_size=4)


def test_cli_mesh_flags_resolve(monkeypatch):
    assert cli.make_cli_mesh(_cli_args(), 4) is None
    assert cli.make_cli_mesh(_cli_args("--mesh", "none"), 4) is None
    mesh = cli.make_cli_mesh(_cli_args("--mesh", "data=1,space=1", "--space", "1"), 4)
    assert (mesh.data, mesh.world, mesh.device) == (1, 1, CPU)
    # as process 0 of 2 (the group itself is the spawned tests' part)
    monkeypatch.setattr(cli.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(cli.dist, "get_world_size", lambda *a: 2)
    with pytest.raises(SystemExit, match="does not split evenly over 2"):
        cli.make_cli_mesh(_cli_args("--mesh", "data=2"), batch_size=5)
    with pytest.raises(SystemExit, match="--num-processes 3"):
        cli.make_cli_mesh(_cli_args("--mesh", "data=3"), batch_size=6)


# two processes (one spawn for the module)


def test_batch_norm_matches_jax_axis_name(dp):
    """Outputs, running statistics, and the input and parameter gradients
    (each process's parameter gradient is its shard's part: their sum is
    the global one)."""
    ranks, want = dp["ranks"], dp["bn_jax"]
    got = {"y": np.concatenate([r["bn.y"] for r in ranks]),
           "x_grad": np.concatenate([r["bn.x_grad"] for r in ranks]),
           "weight_grad": ranks[0]["bn.weight_grad"] + ranks[1]["bn.weight_grad"],
           "bias_grad": ranks[0]["bn.bias_grad"] + ranks[1]["bn.bias_grad"],
           "mean": ranks[0]["bn.mean"], "var": ranks[0]["bn.var"]}
    for k in ("mean", "var"):
        np.testing.assert_array_equal(ranks[1][f"bn.{k}"], got[k])
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= BN_OF_MAX * max(1.0, np.abs(v).max()), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_two_processes_equal_the_one_process_step(dp, name):
    """3 steps with device augmentation: the processes' parameters, running
    statistics, scheduler and generator equal bit for bit after each; the
    loss (the global mean), gradient, parameters and running statistics
    within the f32 gates of the one-process step on the global batch from
    the same state; the scheduler and the generator (the global batch's
    draws) equal to it."""
    ranks, one, lr = dp["ranks"], dp["one"][name], dp["port_lr"]
    for i, want in enumerate(one):
        keys = [k for k in ranks[0] if k.startswith(f"{name}.{i}.")]
        unequal = [k for k in keys if not np.array_equal(ranks[0][k], ranks[1][k])]
        assert keys and not unequal, (i, unequal)
        got = {k[len(f"{name}.{i}."):]: ranks[0][k] for k in keys}
        assert abs(float(got["loss"]) - want["loss"]) <= DP_LOSS_RTOL * abs(want["loss"]), (i, got["loss"])
        np.testing.assert_array_equal(got["generator"], want["generator"])
        for k in ("lr", "num_bad"):
            np.testing.assert_array_equal(got[f"sched.{k}"], want[f"sched.{k}"])
        _within(got, want, lr, f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_world_one_is_the_plain_step_bit_for_bit(dp, name):
    """The Trainer without a mesh (this process alone, every collective
    returning at once; its z noise drawn for the global batch by
    ``train_noise``) against the step in which the model draws its own z
    noise in the forward, in the same process."""
    (run,) = [r for r in dp["ranks"] if f"plain.{name}.0.loss" in r]
    keys = [k for k in run if k.startswith(f"plain.{name}.")]
    for k in keys:
        np.testing.assert_array_equal(run["world1." + k[len("plain."):]], run[k], err_msg=k)


def test_injected_phiseg_step_matches_the_jax_mesh_step(dp):
    """The toy PHiSeg step on JAX's draws, two processes against the JAX
    Trainer's step on a 2-device mesh: the loss within LOSS_RTOL, the whole
    gradient within TRAIN_GRAD_L2 (relative L2; JAX's from Adam's first
    moment), every parameter within F32_PARAM_ATOL_LR lr and the running
    statistics within DP_STATS_OF_MAX of their max."""
    ranks, want, lr = dp["ranks"], dp["jax_step"], dp["port_lr"]
    for k in ranks[0]:
        if k.startswith("injected."):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = ranks[0]
    assert abs(float(got["injected.loss"]) - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    names = sorted(want["grads"])
    g = np.concatenate([got[f"injected.grad.{n}"].ravel() for n in names]).astype(np.float64)
    w = np.concatenate([want["grads"][n].numpy().ravel() for n in names]).astype(np.float64)
    assert np.linalg.norm(g - w) <= TRAIN_GRAD_L2 * np.linalg.norm(w), np.linalg.norm(g - w) / np.linalg.norm(w)
    for k, v in want["state"].items():
        err = np.abs(got[f"injected.{k}"] - v.numpy()).max()
        if "running" in k:
            assert err <= DP_STATS_OF_MAX * v.abs().max().item(), (k, err)
        else:
            assert err <= F32_PARAM_ATOL_LR * lr, (k, err / lr)


def test_two_process_train_validates_and_writes_on_process_0(dp):
    """``Trainer.train`` (4 steps, validations at 2 and 4) on two processes:
    the final states equal bit for bit, and within DP_PARAM_ATOL_LR lr of a
    one-process run's; process 0 wrote the checkpoints and metrics, process 1
    nothing (not even its log directory); validation issued no collective,
    or the spawn would have hung past its time limit."""
    ranks, want, lr = dp["ranks"], dp["train_one"], dp["port_lr"]
    keys = [k for k in ranks[0] if k.startswith("train.")]
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = {k[len("train."):]: ranks[0][k] for k in keys}
    assert abs(float(got["loss"]) - want["loss"]) <= DP_LOSS_RTOL * abs(want["loss"])
    for k, v in want.items():  # the U-Net has no BatchNorm: its free trajectories stay together
        if k != "loss" and not k.startswith(("sched.", "generator")):
            assert np.abs(got[k] - v).max() <= DP_PARAM_ATOL_LR * lr, k
    for k in ("generator", "sched.lr"):
        np.testing.assert_array_equal(got[k], want[k])
    assert MAIN_FILES | {"last"} <= set(os.listdir(dp["tmp"] / "train0"))
    assert not (dp["tmp"] / "train1").exists()

