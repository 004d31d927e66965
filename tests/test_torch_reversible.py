"""The port's memory-mode ops against the JAX package's, at toy shapes.

``ReversibleSequence`` (the coupling blocks, with and without the 1x1
``initial_conv``) against the JAX module on the same weights and input:
train mode through the inverse-reconstruction Function, the output, a loss,
every gradient and the running statistics after the step; eval mode on the
running statistics. The port's ``ReversibleChain`` against plain autograd of
the same coupling chain; remat (``ops.remat``) against plain; what each mode
keeps for the backward; the reversible bridge. JAX runs op by op here (no
jit): these modules are small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu import ops as jops
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.ops import reversible

# f32, JAX against the port on the same weights: the same math in another
# summation order (its one-pass variance in both), so every output and
# gradient within 1e-4 of its max, the running statistics within 1e-6
F32_OF_MAX = 1e-4
STATS_TOL = 1e-6
# the port's Function against autograd of its own chain: the reconstruction
# x1 = y1 - f(x2) is exact up to rounding
FUNCTION_OF_MAX = 1e-5


def _perturbed(variables, seed):
    """The JAX init's variables with BatchNorm's affine parameters and
    running statistics moved off 1 and 0 (U(0.8, 1.2) scales, U(-0.1, 0.1)
    shifts and biases, N(0, 0.2^2) means, U(0.5, 2) variances), as numpy."""
    rng = np.random.default_rng(seed)

    def fill(tree, path=""):
        out = {}
        for k, v in tree.items():
            name = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = fill(v, name)
                continue
            v = np.asarray(v, np.float32)
            if name.endswith(("scale",)):
                v = rng.uniform(0.8, 1.2, v.shape)
            elif name.endswith(("shift", "bn/bias")):
                v = rng.uniform(-0.1, 0.1, v.shape)
            elif name.endswith("mean"):
                v = 0.2 * rng.standard_normal(v.shape)
            elif name.endswith("var"):
                v = rng.uniform(0.5, 2.0, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {"params": fill(variables["params"]), "batch_stats": fill(variables.get("batch_stats", {}))}


def _pair(cin, features, depth, seed=0):
    """A JAX ReversibleSequence, its perturbed variables, the port's twin
    loaded with them through the bridge, and an input."""
    x = np.random.default_rng(seed).standard_normal((2, 8, 6, cin)).astype(np.float32)
    jmod = jops.ReversibleSequence(features=features, depth=depth, mode="reversible")
    variables = _perturbed(jax.device_get(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=True)), seed)
    tmod = ops.ReversibleSequence(cin, features, depth, generator=torch.Generator().manual_seed(seed))
    load_jax_params(tmod, variables["params"], variables["batch_stats"])
    return x, jmod, variables, tmod


def _close(got, want, of_max, label):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.abs(got - want).max() <= of_max * np.abs(want).max(), (label, np.abs(got - want).max())


@pytest.mark.parametrize("cin", [8, 3], ids=["no_initial_conv", "initial_conv"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_train_step_matches_jax(depth, cin):
    """Output, sum(y^2), every parameter's gradient and the running
    statistics after one train-mode step; the coupling biases get an exact
    zero gradient on both sides."""
    x, jmod, variables, tmod = _pair(cin, 8, depth, seed=depth)

    def loss_fn(params, x):
        y, mut = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y ** 2), (y, mut["batch_stats"])

    (val, (y, stats)), (grads, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty = tmod.train()(tx)
    assert type(ty.grad_fn).__name__ == "ReversibleChainBackward"
    loss = (ty ** 2).sum()
    loss.backward()
    _close(ty, y, F32_OF_MAX, "y")
    np.testing.assert_allclose(loss.item(), float(val), rtol=F32_OF_MAX)
    _close(tx.grad, gx, F32_OF_MAX, "x grad")
    want = state_dict_from_jax(jax.device_get(grads), tmod, jax.device_get(stats))
    for name, p in tmod.named_parameters():
        if name.endswith("_bias") or name == "initial_conv.conv.bias":
            assert p.grad is not None and not p.grad.any() and not want[name].any(), name
        else:
            _close(p.grad, want[name], F32_OF_MAX, name)
    for name, b in tmod.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=STATS_TOL, atol=STATS_TOL, err_msg=name)
        assert not torch.equal(b, before[name]), name


@pytest.mark.parametrize("cin", [8, 3], ids=["no_initial_conv", "initial_conv"])
def test_eval_matches_jax(cin):
    """Eval mode: the plain chain on the running statistics, which stay."""
    x, jmod, variables, tmod = _pair(cin, 8, 2, seed=7)

    def loss_fn(params, x):
        return jnp.sum(jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=False) ** 2)

    val, (grads, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tmod.eval()(tx) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val), rtol=F32_OF_MAX)
    _close(tx.grad, gx, F32_OF_MAX, "x grad")
    want = state_dict_from_jax(jax.device_get(grads), tmod, variables["batch_stats"])
    for name, p in tmod.named_parameters():
        if not name.endswith("bias"):
            _close(p.grad, want[name], F32_OF_MAX, name)
    assert all(torch.equal(v, before[k]) for k, v in tmod.state_dict().items())


# bf16: each reconstruction x1 = y1 - f(x2) starts from outputs rounded to
# bf16, and BatchNorm over a few values amplifies that. Measured on the CPU
# (four toy shapes, three seeds): autograd's own bf16 gradient lies 4.8-8.6%
# (relative L2) from the f32 gradient, the Function's 1.4-8.5%, at most 1.44
# times as far; so the Function's is held within BF16_VS_AUTOGRAD times
# autograd's distance from the f32 gradient, plus 0.01
BF16_VS_AUTOGRAD = 2.0


def _chain_grads(fn, seq, x, g):
    x = x.detach().requires_grad_()
    params = [p.detach().requires_grad_() for p in seq.parameters()]
    y = fn(x, params)
    return y, torch.cat([t.float().flatten() for t in torch.autograd.grad(y, [x, *params], g)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_matches_autograd(dtype):
    """``ReversibleChain`` (no activation kept) against autograd of the same
    chain (every activation kept): the output bit for bit, each gradient
    within FUNCTION_OF_MAX of its max in f32, and in bf16 as far from the f32
    gradient as BF16_VS_AUTOGRAD allows."""
    seq = ops.ReversibleSequence(16, 16, 3, generator=torch.Generator().manual_seed(1)).train()
    gen = torch.Generator().manual_seed(2)
    x, g = (torch.randn((4, 16, 16, 16), generator=gen) for _ in range(2))

    def function(x, p):
        return reversible.ReversibleChain.apply(x, None, *p)[0]

    def autograd(x, p):
        return reversible.coupling_chain(x, reversible._blocks(p))[0]

    y, got = _chain_grads(function, seq, x.to(dtype), g.to(dtype))
    y2, want = _chain_grads(autograd, seq, x.to(dtype), g.to(dtype))
    assert torch.equal(y, y2) and type(seq(x.to(dtype).requires_grad_()).grad_fn).__name__ == "ReversibleChainBackward"
    if dtype == torch.float32:
        sizes = [t.numel() for t in (x, *seq.parameters())]
        for a, b in zip(got.split(sizes), want.split(sizes)):
            assert (a - b).abs().max() <= FUNCTION_OF_MAX * b.abs().max()
    else:
        _, f32 = _chain_grads(autograd, seq, x, g)
        norm = f32.norm()
        assert (got - f32).norm() / norm <= BF16_VS_AUTOGRAD * (want - f32).norm() / norm + 0.01


def test_stats_fold_once_a_step_and_not_without_train_mode():
    seq = ops.ReversibleSequence(4, 4, 1, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 5, 5, 4), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        seq.eval()(x)
        assert torch.equal(seq.block0_f_var, torch.ones(2))
        seq.train()(x)  # no autograd: the plain chain, folded once
    once = seq.block0_f_mean.clone()
    _, stats = reversible.coupling_chain(x, seq.blocks())
    torch.testing.assert_close(once, reversible.MOMENTUM * stats[0][0][0], rtol=0, atol=1e-7)
    assert seq.block0_f_mean.dtype == torch.float32


@pytest.mark.parametrize("norm", [True, False])
def test_remat_equals_plain_and_updates_statistics_once(norm):
    """``ConvSeq(remat=True)`` against the plain ``ConvSeq`` on the same
    weights: the output, every gradient, and the running statistics after
    one step, which the backward's re-run must not update a second time."""
    a, b = (ops.ConvSeq(3, 6, 3, norm=norm, init_scheme="torch_default", remat=remat,
                        generator=torch.Generator().manual_seed(4)) for remat in (False, True))
    x = torch.randn((2, 7, 5, 3), generator=torch.Generator().manual_seed(5))
    outs = []
    for seq in (a, b):
        tx = x.clone().requires_grad_()
        y = seq(tx)
        (y ** 2).sum().backward()
        outs.append((y, tx.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=0, atol=0)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, s), t in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(s, t), name
    if norm:
        assert not torch.equal(a.conv0.bn.running_var, torch.ones(6))


def test_remat_is_checkpointed_and_plain_without_grad():
    seq = ops.ConvSeq(3, 4, 2, norm=True, remat=True, generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 4, 4, 3), requires_grad=True)
    with torch.no_grad():
        assert seq(x).grad_fn is None
    calls = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: calls.append(t) or t, lambda t: t):
        seq(x).sum().backward()
    # the sequence keeps its input; the re-run's saves go to checkpoint's own hooks
    assert len(calls) == 1 and calls[0] is x
    assert x.grad is not None


def _saved_bytes(module, x):
    """Bytes autograd keeps for the backward of ``module(x)``, beside the
    parameters: what ``saved_tensors_hooks`` receives during the forward
    (checkpoint's own hooks sit inside it, so a checkpointed region shows
    only what it really stores)."""
    params = {p.data_ptr() for p in module.parameters()}
    seen = {}

    def pack(t):
        if t.data_ptr() not in params:
            seen[(t.data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = module(x)
    return sum(seen.values()), y


@pytest.mark.parametrize("kind", ["phiseg_block", "unet_block"])
def test_memory_modes_keep_less(kind):
    """A block's saved activations: plain > remat and plain > reversible;
    a reversible block with no initial conv keeps its output and nothing
    else."""
    from unet_zoo_tpu_torch.models.blocks import DownBlock, PhiDownBlock

    x = torch.randn((2, 32, 32, 16), generator=torch.Generator().manual_seed(0)).requires_grad_()
    cls = PhiDownBlock if kind == "phiseg_block" else DownBlock
    saved = {}
    for mode in ops.MEMORY_MODES:
        block = cls(16, 16, pool=False, reversible_mode=mode, generator=torch.Generator().manual_seed(1)).train()
        saved[mode], y = _saved_bytes(block, x)
        if mode == "reversible":
            assert saved[mode] == y.untyped_storage().nbytes()
    assert saved["remat"] < saved["plain"] and saved["reversible"] < saved["plain"], saved


def test_reversible_bridge_round_trips_and_checks():
    x, jmod, variables, tmod = _pair(3, 8, 2)
    state = state_dict_from_jax(variables["params"], tmod, variables["batch_stats"])
    assert "block1_g_kernel" in state and "block0_f_mean" in state and "initial_conv.bn.running_var" in state
    assert tuple(state["block0_f_kernel"].shape) == (4, 4, 3, 3)
    np.testing.assert_array_equal(state["block1_g_kernel"].numpy(),
                                  variables["params"]["block1_g_kernel"].transpose(3, 2, 0, 1))
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, state[k]), k
    params = variables["params"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax({k: v for k, v in params.items() if k != "block1_f_scale"}, tmod, variables["batch_stats"])
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_jax({**params, "block2_f_scale": np.ones(4, np.float32)}, tmod, variables["batch_stats"])
    with pytest.raises(KeyError, match="unexpected leaf"):
        state_dict_from_jax({**params, "block0_h_kernel": np.ones(4, np.float32)}, tmod, variables["batch_stats"])
    with pytest.raises(ValueError, match="block0_f_kernel"):
        state_dict_from_jax({**params, "block0_f_kernel": np.ones((3, 3, 4, 5), np.float32)}, tmod,
                            variables["batch_stats"])


def test_sequence_checks_its_arguments():
    with pytest.raises(ValueError, match="even"):
        ops.ReversibleSequence(4, 5)
    with pytest.raises(ValueError, match="depth"):
        ops.ReversibleSequence(4, 4, 0)
    with pytest.raises(ValueError, match="memory mode"):
        ops.conv_sequence(4, 4, 2, mode="revnet")
    assert isinstance(ops.conv_sequence(4, 6, 2, mode="reversible", rev_depth=3), ops.ReversibleSequence)
    assert ops.conv_sequence(4, 6, 2, mode="reversible", rev_depth=3).depth == 3
    assert ops.conv_sequence(4, 6, 2, mode="remat").remat
