"""Spatial sharding of the PyTorch port (``unet_zoo_tpu_torch.parallel.space``:
the mesh's "space" axis above 1) against the unsharded port and the JAX
package, on the CPU.

The four-process cases run in one spawn of four processes
(``tests/torch_space_worker.py``, gloo over 127.0.0.1, a time limit),
started once for the module while the JAX package's step compiles here.
Each process builds both meshes through the CLI's flags, ``--mesh
data=2,space=2`` and ``--space 4`` (one data group of four; at 32x32 the
toy PHiSeg's 2x2 level stays replicated there), and runs on each:

* ``halo``, ``gather`` and ``scatter``, each against autograd of its
  unsharded op;
* a halo-exchanged 3x3 ``Conv`` against ``unet_zoo_tpu.ops.Conv`` on the
  same weights (the JAX twin is ``tests/test_parallel.py``'s
  ``test_spatial_sharding_conv_correctness``);
* the halo chain (``ConvSeq(norm=False)``, its plain version here) against
  the unsharded chain, outputs and gradients;
* a train-mode ``BatchNorm`` over the mesh on a replicated level, whose
  sums and count both carry the factor ``space``;
* one train step of the toy U-Net (f32), PHiSeg (plain, remat,
  reversible), PHiSeg3D (16^3) and ProbUNet against the port's
  one-process step on the global batch from the same state and draws: the
  loss and the whole gradient at the JAX package's space gates
  (``tests/test_parallel.py``'s ``test_space_sharded_grads_match_dp``),
  tighter for the U-Net; every module's local output height is its global
  height's share by the rule (a level that should be sharded cannot pass
  replicated);
* one toy PHiSeg step on the JAX package's draws against the JAX
  ``Trainer``'s unsharded step, at the gates of
  ``tests/test_torch_parallel.py``'s
  ``test_injected_phiseg_step_matches_the_jax_mesh_step``.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_augment import jax_draws, jax_options
from test_torch_parallel import DP_STATS_OF_MAX
from test_torch_phiseg import LOSS_RTOL, TRAIN_GRAD_L2
from test_torch_phiseg import _variables as phiseg_variables
from test_torch_training import F32_PARAM_ATOL_LR
from test_torch_uzh import _noise
from torch_space_worker import AUG, CONFIGS, INJECTED, MESHES, step
from unet_zoo_tpu import ops as jax_ops
from unet_zoo_tpu.experiments import ExperimentConfig as JaxExperimentConfig
from unet_zoo_tpu.models.phiseg import PHiSeg as JaxPHiSeg
from unet_zoo_tpu.training import Trainer as JaxTrainer
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import state_dict_from_jax
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.parallel import space as space_lib
from unet_zoo_tpu_torch.training import Trainer

WORKER = Path(__file__).resolve().parent / "torch_space_worker.py"
SPAWN_TIMEOUT = 240  # seconds for the four processes' whole run
WORLD = 4
# (data, space) of each mesh
SHAPE = {"d2s2": (2, 2), "d1s4": (1, 4)}
# the JAX package's gates of a sharded step against an unsharded one
# (test_space_sharded_grads_match_dp): the loss relative, the whole gradient
# as one vector in relative L2. Measured here: losses 0 to 1.5e-6 apart,
# gradients 1.4e-6 to 1.2e-5 (the same sums in another order: BatchNorm's
# all-reduced sums, the halo convs' tiles, the gradient all-reduce); one
# process differs from itself by 2.1e-4 with 1 and 4 threads on a 48x48
# PHiSeg, whose train-mode BatchNorm amplifies rounding
SPACE_LOSS_RTOL, SPACE_GRAD_L2 = 1e-5, 1e-3
# the f32 U-Net has no BatchNorm: measured 0 and 1.2e-7
UNET_LOSS_RTOL, UNET_GRAD_L2 = 1e-6, 1e-5
# a primitive's output is a copy (exact); its gradient sums at most `space`
# terms in another order
PRIM_RTOL = 1e-6
# the halo conv against the JAX conv (as the JAX twin holds its own)
CONV_ATOL = 1e-5
# the halo chain against the unsharded chain, f32, of max|ref|: the tile's
# convs against the whole image's (measured 0 to 2e-7)
CHAIN_OF_MAX = 1e-5
# BatchNorm over the mesh against one process: the same values summed in
# another order (as tests/test_torch_parallel.py's BN_OF_MAX)
BN_OF_MAX = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_of(tag: str, group: int, index: int) -> int:
    return group * SHAPE[tag][1] + index


def _stitch(ranks: list, key: str, tag: str, sharded: bool = True) -> np.ndarray:
    """The global tensor of per-process ``key``: each data group's space
    processes' rows along axis 1 (one of them where ``sharded`` is False),
    the groups along axis 0."""
    data, space = SHAPE[tag]
    groups = []
    for d in range(data):
        parts = [ranks[_rank_of(tag, d, i)][key] for i in range(space)]
        groups.append(np.concatenate(parts, axis=1) if sharded else parts[0])
    return np.concatenate(groups, axis=0)


def _inputs(rng) -> dict:
    """Every process's inputs, drawn from ``rng``."""
    x = rng.standard_normal((2, 16, 5, 3)).astype(np.float32)
    inputs = {"prim.x": x}
    for tag, (data, space) in SHAPE.items():
        h = x.shape[1] // space
        inputs[f"prim.halo_cot.{tag}"] = rng.standard_normal((2, space, h + 2, 5, 3)).astype(np.float32)
        inputs[f"prim.gather_cot.{tag}"] = rng.standard_normal((2, space, 16, 5, 3)).astype(np.float32)
        inputs[f"prim.scatter_cot.{tag}"] = rng.standard_normal((2, space, h, 5, 3)).astype(np.float32)
    inputs["conv.x"] = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    inputs["chain.x"] = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    for j, (ci, co) in enumerate([(3, 8), (8, 8), (8, 8)]):
        inputs[f"chain.w{j}"] = (rng.standard_normal((co, ci, 3, 3)) * (2 / (9 * ci)) ** 0.5).astype(np.float32)
        inputs[f"chain.b{j}"] = (rng.standard_normal(co) * 0.1).astype(np.float32)
    inputs["chain.cot"] = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    inputs["bn.base"] = rng.standard_normal((4, 6, 10, 1)).astype(np.float32)
    inputs["bn.x"] = (rng.standard_normal((4, 3, 5, 6)) * 2 + 1).astype(np.float32)
    inputs["bn.weight"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    inputs["bn.bias"] = rng.standard_normal(6).astype(np.float32)
    inputs["bn.cot"] = rng.standard_normal((4, 3, 5, 6)).astype(np.float32)
    for name, cfg in CONFIGS.items():
        if cfg["model"] == "phiseg3d":
            xs = rng.standard_normal((4, 16, 16, 16, 4)).astype(np.float32)
            ys = (rng.random((4, 16, 16, 16, 3)) > 0.5).astype(np.float32)
        else:
            xs = rng.standard_normal((4, 32, 32, 1)).astype(np.float32)
            ys = (xs[..., 0] > 0).astype(np.int64)
        inputs[f"steps.{name}.x"], inputs[f"steps.{name}.y"] = xs, ys
    return inputs


def _jax_trainer(tmp: Path):
    """The JAX ``Trainer`` of the injected toy, unsharded, on variables drawn
    with numpy (its own init would take half a minute op by op)."""
    jcfg = JaxExperimentConfig(**{**INJECTED, "augmentation_options": jax_options(AUG)})
    variables = phiseg_variables(dict(num_filters=INJECTED["filter_channels"], latent_levels=INJECTED["latent_levels"],
                                      image_size=INJECTED["image_size"]), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPHiSeg, "init", lambda self, *args, **kwargs: variables)
        return JaxTrainer(jcfg, log_dir=str(tmp / "jax"), tensorboard=False)


@pytest.fixture(scope="module")
def space(tmp_path_factory):
    """The four processes' results (``ranks``) beside what they are held to:
    the JAX conv and step and the one-process port steps."""
    tmp = tmp_path_factory.mktemp("space")
    rng = np.random.default_rng(0)
    inputs = _inputs(rng)

    jconv = jax_ops.Conv(8, kernel_size=3)
    conv_params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(inputs["conv.x"]))
    kernel = np.asarray(conv_params["params"]["kernel"])
    inputs["conv.weight"] = np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
    inputs["conv.bias"] = np.asarray(conv_params["params"]["bias"])

    # the injected step: JAX's state, inputs and draws, and the port's weights for it
    jtr = _jax_trainer(tmp)
    jstate = jtr.state
    jx = rng.standard_normal((4, 32, 32, 1)).astype(np.float32)
    jy = (jx[..., 0] > 0).astype(np.int32)
    _, k_aug, k_z = jax.random.split(jstate.rng, 3)
    draws = jax_draws(k_aug, 4, (32, 32), AUG)
    (z_eps,) = _noise(INJECTED, 4, k_z, posterior_only=True)
    port = Trainer(ExperimentConfig(**INJECTED), device="cpu", tensorboard=False, log_dir=str(tmp / "p"))
    params0, stats0 = jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    weights = state_dict_from_jax(params0, port.state.model, stats0)
    inputs.update({**{f"injected.w.{k}": v.numpy() for k, v in weights.items()},
                   **{f"injected.aug.{f}": getattr(draws, f).numpy() for f in draws._fields},
                   **{f"injected.z.{i}": e.numpy() for i, e in enumerate(z_eps)},
                   "injected.x": jx, "injected.y": jy.astype(np.int64)})
    np.savez(tmp / "in.npz", **inputs)

    port_ = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # each process writes into a file: pipes read one after another deadlock
    # where a later process fills its pipe while the first waits for it
    logs = [open(tmp / f"worker_{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), port_, str(tmp)], env=env,
                              stdout=f, stderr=subprocess.STDOUT) for r, f in enumerate(logs)]
    threads = torch.get_num_threads()
    try:
        # meanwhile: the JAX conv and step (it donates its state), the one-process steps
        conv_jax = np.asarray(jconv.apply(conv_params, jnp.asarray(inputs["conv.x"])))
        jstate1, jaux = jtr._train_step(jstate, jnp.asarray(jx), jnp.asarray(jy))
        wd = JaxExperimentConfig(**{**INJECTED, "augmentation_options": None}).weight_decay
        (mu,) = [s.mu for s in jax.tree_util.tree_leaves(jstate1.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                 if hasattr(s, "mu")]
        jgrads = jax.tree_util.tree_map(lambda m, p: np.asarray(m) / (1 - 0.9) - wd * np.asarray(p),
                                        jax.device_get(mu), params0)
        jax_step = {"loss": float(jaux["loss"]),
                    "state": state_dict_from_jax(jax.device_get(jstate1.params), port.state.model,
                                                 jax.device_get(jstate1.batch_stats)),
                    "grads": {k: v for k, v in state_dict_from_jax(jgrads, port.state.model, stats0).items()
                              if "running" not in k}}
        torch.set_num_threads(1)
        one = {name: step(cfg, None, inputs[f"steps.{name}.x"], inputs[f"steps.{name}.y"], str(tmp / "one"))
               for name, cfg in CONFIGS.items()}
        start = time.monotonic()
        for p in procs:
            p.wait(timeout=max(1.0, SPAWN_TIMEOUT - (time.monotonic() - start)))
    finally:
        torch.set_num_threads(threads)  # the one-process steps ran as the workers do; the next test may not
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        out = (tmp / f"worker_{r}.log").read_text()
        assert p.returncode == 0 and f"DONE {r}" in out, f"process {r}:\n{out}"
    ranks = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(WORLD)]
    return {"inputs": inputs, "ranks": ranks, "conv_jax": conv_jax, "one": one, "jax_step": jax_step,
            "lr": port.cfg.learning_rate}


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want.astype(np.float64)))


# the rule and the interpolation matrices, in one process


@pytest.mark.parametrize("height, size, want", [
    (128, 2, True), (3, 2, False), (6, 4, False), (2, 4, False), (4, 4, True), (12, 4, True), (1, 2, False),
])
def test_shardable_reads_the_global_height(height, size, want):
    assert space_lib.shardable(height, size) is want
    rows = [space_lib.rows_of(height, size, i) for i in range(size)]
    if want:
        assert [r.stop - r.start for r in rows] == [height // size] * size and rows[-1].stop == height
    else:
        assert rows == [slice(0, height)] * size


def test_pyramid_keys_tell_a_sharded_6_from_a_replicated_3():
    """UZH 192x192 reaches 6 and 3 rows: at space 2 both are 3 rows a
    process, told apart by their width."""
    sizes = space_lib.pyramid((192, 192))
    assert sizes[:7] == [(s, s) for s in (192, 96, 48, 24, 12, 6, 3)] and sizes[-1] == (1, 1)
    sp = space_lib.Space(group=None, size=2, index=1, up=0, down=None)
    sp.shard(torch.zeros(1, 192, 192, 1))
    sharded6, replicated3 = torch.zeros(1, 3, 6, 4), torch.zeros(1, 3, 3, 4)
    assert (sp.global_height(sharded6), sp.is_sharded(sharded6)) == (6, True)
    assert (sp.global_height(replicated3), sp.is_sharded(replicated3)) == (3, False)
    assert sp.own(sharded6) == 1.0 and sp.own(replicated3) == 0.0 and sp.own(torch.zeros(2, 3)) == 0.0
    with pytest.raises(ValueError, match="rows a process"):
        sp.global_height(torch.zeros(1, 6, 6, 4))
    with pytest.raises(ValueError, match="no activation"):
        sp.global_height(torch.zeros(1, 3, 7, 4))


@pytest.mark.parametrize("n_in, n_out, mode, align_corners", [
    (16, 32, "linear", False), (16, 32, "linear", True), (5, 9, "linear", True), (3, 6, "linear", False),
    (9, 17, "linear", False), (4, 16, "nearest", None), (3, 7, "nearest", None),
])
def test_interpolation_matrix_is_torchs(n_in, n_out, mode, align_corners):
    x = torch.randn(2, 3, n_in, generator=torch.Generator().manual_seed(0))
    kw = {} if mode == "nearest" else {"align_corners": align_corners}
    want = F.interpolate(x, size=n_out, mode=mode, **kw)
    got = torch.einsum("oh,bch->bco", space_lib._matrix(n_in, n_out, mode, align_corners), x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# four processes (one spawn for the module)


@pytest.mark.parametrize("tag", sorted(SHAPE))
@pytest.mark.parametrize("name", ["halo", "gather", "scatter"])
def test_primitive_backward_is_the_unsharded_ops(space, name, tag):
    """Each primitive's output and its input's gradient against autograd of
    the unsharded op on the global tensor: the zero-padded image cut into
    ``h + 2``-row tiles (halo), the whole image on every process (gather),
    its rows (scatter)."""
    data, size = SHAPE[tag]
    ranks, x = space["ranks"], torch.from_numpy(space["inputs"]["prim.x"]).requires_grad_()
    cot = torch.from_numpy(space["inputs"][f"prim.{name}_cot.{tag}"])
    b, h = x.shape[0] // data, x.shape[1] // size
    loss, want_y = 0, {}
    for d in range(data):
        for i in range(size):
            rows = slice(d * b, (d + 1) * b)
            if name == "halo":
                y = F.pad(x[rows], (0, 0, 0, 0, 1, 1))[:, i * h:i * h + h + 2]
            elif name == "gather":
                y = x[rows]
            else:
                y = x[rows][:, i * h:(i + 1) * h]
            want_y[_rank_of(tag, d, i)] = y.detach().numpy()
            loss = loss + (y * cot[rows][:, i]).sum()
    loss.backward()
    for r, y in want_y.items():
        np.testing.assert_array_equal(ranks[r][f"{tag}.{name}.y"], y, err_msg=f"process {r}")
    if name == "scatter":  # each process's gradient of the whole image it holds: its rows' cotangent
        for d in range(data):
            for i in range(size):
                g = np.zeros((b, *x.shape[1:]), np.float32)
                g[:, i * h:(i + 1) * h] = cot[d * b:(d + 1) * b, i].numpy()
                np.testing.assert_array_equal(ranks[_rank_of(tag, d, i)][f"{tag}.scatter.grad"], g)
        return
    got = _stitch(ranks, f"{tag}.{name}.grad", tag)
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=PRIM_RTOL, atol=PRIM_RTOL * np.abs(x.grad.numpy()).max())


@pytest.mark.parametrize("tag", sorted(SHAPE))
def test_halo_conv_matches_jax(space, tag):
    got = _stitch(space["ranks"], f"{tag}.conv.y", tag)
    np.testing.assert_allclose(got, space["conv_jax"], atol=CONV_ATOL)


@pytest.mark.parametrize("tag", sorted(SHAPE))
def test_halo_chain_matches_the_unsharded_chain(space, tag):
    """Outputs and the input's gradient stitched; the parameters' gradients
    summed over the processes (each holds its rows' part)."""
    inputs, ranks = space["inputs"], space["ranks"]
    n = sum(k.startswith("chain.w") for k in inputs)
    seq = ops.ConvSeq(3, 8, n, norm=False)
    with torch.no_grad():
        for j in range(n):
            getattr(seq, f"conv{j}").conv.weight.copy_(torch.from_numpy(inputs[f"chain.w{j}"]))
            getattr(seq, f"conv{j}").conv.bias.copy_(torch.from_numpy(inputs[f"chain.b{j}"]))
    x = torch.from_numpy(inputs["chain.x"]).requires_grad_()
    y = seq(x)
    (y * torch.from_numpy(inputs["chain.cot"])).sum().backward()
    want = {"chain.y": y.detach().numpy(), "chain.x_grad": x.grad.numpy()}
    for k, v in want.items():
        got = _stitch(ranks, f"{tag}.{k}", tag)
        assert np.abs(got - v).max() <= CHAIN_OF_MAX * np.abs(v).max(), k
    for k, p in seq.named_parameters():
        got = sum(r[f"{tag}.chain.grad.{k}"].astype(np.float64) for r in ranks)
        assert np.abs(got - p.grad.numpy()).max() <= CHAIN_OF_MAX * np.abs(p.grad.numpy()).max(), k


@pytest.mark.parametrize("tag", sorted(SHAPE))
def test_batch_norm_over_the_mesh_on_a_replicated_level(space, tag):
    """A replicated level's ``space`` copies scale the mesh's sums and count
    alike: the statistics, outputs and gradients are one process's on the
    global batch (the input's gradient summed over each data group's
    copies, the parameters' over every process)."""
    inputs, ranks = space["inputs"], space["ranks"]
    bn = ops.BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn.weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn.bias"]))
    x = torch.from_numpy(inputs["bn.x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inputs["bn.cot"])).sum().backward()
    data, size = SHAPE[tag]
    x_grad = np.concatenate([sum(ranks[_rank_of(tag, d, i)][f"{tag}.bn.x_grad"] for i in range(size))
                             for d in range(data)])
    got = {"y": _stitch(ranks, f"{tag}.bn.y", tag, sharded=False), "x_grad": x_grad,
           "weight_grad": sum(r[f"{tag}.bn.weight_grad"] for r in ranks),
           "bias_grad": sum(r[f"{tag}.bn.bias_grad"] for r in ranks),
           "mean": ranks[0][f"{tag}.bn.mean"], "var": ranks[0][f"{tag}.bn.var"]}
    want = {"y": y.detach().numpy(), "x_grad": x.grad.numpy(), "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= BN_OF_MAX * max(1.0, np.abs(v).max()), k


@pytest.mark.parametrize("tag", sorted(SHAPE))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_space_step_matches_the_one_process_step(space, name, tag):
    """The loss (the global batch's, every process's part summed), the
    whole gradient and the running statistics after it (a replicated
    level's unbiased variance counts its values once) against the
    one-process step on the global batch from the same state and draws;
    every process holds one state after it."""
    one, ranks = space["one"][name], space["ranks"]
    loss_rtol, grad_l2 = (UNET_LOSS_RTOL, UNET_GRAD_L2) if name == "unet" else (SPACE_LOSS_RTOL, SPACE_GRAD_L2)
    for r in ranks:
        assert bool(r[f"{tag}.{name}.replicated"])
        assert abs(float(r[f"{tag}.{name}.loss"]) - float(one["loss"])) <= loss_rtol * abs(float(one["loss"]))
    keys = sorted(k for k in one if k.startswith("grad."))
    got = np.concatenate([ranks[0][f"{tag}.{name}.{k}"].ravel() for k in keys])
    want = np.concatenate([one[k].ravel() for k in keys])
    assert _rel_l2(got, want) <= grad_l2, _rel_l2(got, want)
    for k in (k for k in one if k.startswith("state.") and ("running" in k or k.endswith(("_mean", "_var")))):
        err = np.abs(ranks[0][f"{tag}.{name}.{k}"] - one[k]).max()
        assert err <= DP_STATS_OF_MAX * np.abs(one[k]).max(), (k, err)


@pytest.mark.parametrize("tag", sorted(SHAPE))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_activations_are_sharded_by_the_rule(space, name, tag):
    """Every module's output on every process: its data group's images, and
    its global height's share where that splits evenly over the space
    axis, the whole height where it does not."""
    data, size = SHAPE[tag]
    one, ranks = space["one"][name], space["ranks"]
    modules = [k[len("shapes."):] for k in one if k.startswith("shapes.")]
    replicated_levels = 0
    for m in modules:
        want = one[f"shapes.{m}"]
        for r in ranks:
            got = r[f"{tag}.{name}.shapes.{m}"]
            assert got.shape == want.shape, m
            for g, w in zip(got, want):
                local = w[1] // size if space_lib.shardable(int(w[1]), size) else w[1]
                assert (g[0], g[1], *g[2:]) == (w[0] // data, local, *w[2:]), (m, tuple(g), tuple(w))
                replicated_levels += int(local == w[1])
    if name == "phiseg" and tag == "d1s4":
        assert replicated_levels > 0  # the 2x2 level


def test_injected_step_matches_the_jax_step(space):
    """The toy PHiSeg step on JAX's draws on the data=2, space=2 mesh against
    the JAX Trainer's unsharded step: the loss within LOSS_RTOL, the whole
    gradient within TRAIN_GRAD_L2 (JAX's from Adam's first moment), every
    parameter within F32_PARAM_ATOL_LR lr and the running statistics
    within DP_STATS_OF_MAX of their max."""
    ranks, want, lr = space["ranks"], space["jax_step"], space["lr"]
    for r in ranks:
        assert bool(r["injected.replicated"])
    got = ranks[0]
    assert abs(float(got["injected.loss"]) - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    names = sorted(want["grads"])
    g = np.concatenate([got[f"injected.grad.{n}"].ravel() for n in names])
    w = np.concatenate([want["grads"][n].numpy().ravel() for n in names])
    assert _rel_l2(g, w) <= TRAIN_GRAD_L2, _rel_l2(g, w)
    for k, v in want["state"].items():
        err = np.abs(got[f"injected.state.{k}"] - v.numpy()).max()
        if "running" in k:
            assert err <= DP_STATS_OF_MAX * v.abs().max().item(), (k, err)
        else:
            assert err <= F32_PARAM_ATOL_LR * lr, (k, err / lr)
