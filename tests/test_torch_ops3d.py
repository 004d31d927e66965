"""The port's ops on NDHWC (3D) input against the JAX package's, on the same
numpy inputs: conv (the DHWIO -> OIDHW bridge), ConvBNAct in train and eval
mode, the BN-free conv sequence's refusal, BatchNorm, the ceil-mode pool
and the tri-linear and nearest resizes at odd sizes (forward and
gradient), and the 3D reversible sequence (its coupling function's
``3**3 * C/2`` bias fan-in, forward, running statistics and gradients).
JAX runs op by op here (no jit): every graph is a few ops at toy sizes.

Tolerance, f32: 1e-5 of max|ref| on the ops and 1e-4 of max|ref| where a
whole sequence or its gradient is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu import ops as jops
from unet_zoo_tpu.ops.norm import BatchNorm as JaxBatchNorm
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.ops.conv import conv3d_ndhwc

OP_OF_MAX = 1e-5
SEQ_OF_MAX = 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, of_max, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.abs(got - want).max() <= of_max * np.abs(want).max(), (label, np.abs(got - want).max())


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 3), (2, 7, 9, 5, 3), (1, 3, 4, 3, 2)])
def test_avg_pool_ceil_3d_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = _np(rng, *shape)
    want, vjp = jax.vjp(jops.avg_pool_ceil, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = ops.avg_pool_ceil(tx)
    _close(got, want, OP_OF_MAX, "pool")
    g = _np(rng, *got.shape)
    got.backward(torch.from_numpy(g))
    _close(tx.grad, vjp(jnp.asarray(g))[0], OP_OF_MAX, "pool grad")


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("shape,out", [((2, 7, 9, 5, 2), (13, 17, 9)), ((1, 8, 8, 8, 3), (16, 16, 16)),
                                       ((1, 13, 17, 9, 2), (7, 9, 5))])
def test_resize_linear_3d_matches_jax(shape, out, align):
    rng = np.random.default_rng(1)
    x = _np(rng, *shape)
    want, vjp = jax.vjp(lambda a: jops.resize_linear(a, out, align_corners=align), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = ops.resize_linear(tx, out, align_corners=align)
    assert got.shape == (shape[0], *out, shape[-1])
    _close(got, want, OP_OF_MAX, "trilinear")
    g = _np(rng, *got.shape)
    got.backward(torch.from_numpy(g))
    _close(tx.grad, vjp(jnp.asarray(g))[0], OP_OF_MAX, "trilinear grad")


@pytest.mark.parametrize("out", [(14, 18, 10), (16, 16, 16)])
def test_upsample_nearest_3d_matches_jax(out):
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 7, 9, 5, 3) if out[0] == 14 else _np(rng, 1, 8, 8, 8, 2)
    want, vjp = jax.vjp(lambda a: jops.upsample_nearest(a, out), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = ops.upsample_nearest(tx, out)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = _np(rng, *got.shape)
    got.backward(torch.from_numpy(g))
    _close(tx.grad, vjp(jnp.asarray(g))[0], OP_OF_MAX, "nearest grad")


def test_rank_checks():
    with pytest.raises(ValueError):
        ops.avg_pool_ceil(torch.zeros(2, 4, 4))
    with pytest.raises(ValueError):
        ops.resize_linear(torch.zeros(1, 4, 4, 4, 2), (8, 8), align_corners=True)
    with pytest.raises(ValueError, match="ndim"):
        ops.Conv(2, 2, ndim=4)


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_conv_3d_matches_jax(kernel_size):
    """DHWIO -> OIDHW through the bridge, the torch padding rule, a tuple
    input as a channel concat."""
    rng = np.random.default_rng(3)
    a, b = _np(rng, 2, 7, 6, 5, 3), _np(rng, 2, 7, 6, 5, 2)
    jmod = jops.Conv(4, kernel_size, init_scheme="torch_default")
    variables = jmod.init(jax.random.PRNGKey(0), (jnp.asarray(a), jnp.asarray(b)))
    want = jmod.apply(variables, (jnp.asarray(a), jnp.asarray(b)))
    tmod = load_jax_params(ops.Conv(5, 4, kernel_size, ndim=3), jax.device_get(variables["params"]))
    assert tmod.weight.shape == (4, 5) + (kernel_size,) * 3
    _close(tmod((torch.from_numpy(a), torch.from_numpy(b))), want, OP_OF_MAX, "conv3d")
    kernel = np.asarray(variables["params"]["kernel"])
    np.testing.assert_array_equal(tmod.weight.detach().numpy(), kernel.transpose(4, 3, 0, 1, 2))


def test_conv3d_ndhwc_bf16_cast_points():
    """Operands in bf16, the bias added in f32, the result rounded once more,
    as ``conv2d_nhwc`` (2 bf16 ulps of max|ref| from the f32 conv)."""
    rng = np.random.default_rng(4)
    x, w, bias = (torch.from_numpy(_np(rng, *s)) for s in ((1, 5, 6, 7, 4), (3, 4, 3, 3, 3), (3,)))
    got = conv3d_ndhwc(x.bfloat16(), w, bias, 1)
    want = conv3d_ndhwc(x, w, bias, 1)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 5, 6, 7, 3)
    assert (got.float() - want).abs().max() <= 4 * 2.0 ** -8 * want.abs().max()


def _perturbed_stats(variables, seed):
    """Running statistics away from 0 and 1: variances U(0.5, 2), means U(-0.75, 0.75)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 2.0, v.shape) - (0 if "var" in jax.tree_util.keystr(p) else 1.25)
                      ).astype(np.float32), jax.device_get(variables["batch_stats"]))


@pytest.mark.parametrize("train", [True, False])
def test_conv_bn_act_3d_matches_jax(train):
    """ConvBNAct over NDHWC: BatchNorm's statistics over (N, D, H, W), the
    running statistics it leaves, and the gradients of every parameter."""
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 5, 6, 7, 3)
    jmod = jops.ConvBNAct(4)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    stats = _perturbed_stats(variables, 6)
    params = jax.device_get(variables["params"])
    g = _np(rng, 2, 5, 6, 7, 4)

    def f(p):
        y, mut = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (want, new_stats)), grads = jax.value_and_grad(f, has_aux=True)(params)
    tmod = load_jax_params(ops.ConvBNAct(3, 4, ndim=3), params, stats).train(train)
    got = tmod(torch.from_numpy(x))
    (got * torch.from_numpy(g)).sum().backward()
    _close(got, want, OP_OF_MAX, "conv+bn")
    want_state = state_dict_from_jax(jax.device_get(grads), tmod, jax.device_get(new_stats))
    for name, p in tmod.named_parameters():
        if name == "conv.bias":  # BN follows: an exact zero on both sides
            assert not p.grad.any() and not want_state[name].any()
        else:
            _close(p.grad, want_state[name], SEQ_OF_MAX, name)
    for name, buf in tmod.named_buffers():
        _close(buf, want_state[name], OP_OF_MAX, name)


def test_batch_norm_5d_matches_jax():
    rng = np.random.default_rng(7)
    x = _np(rng, 2, 3, 4, 5, 6) * 3 + 1
    jbn = JaxBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    want, mut = jbn.apply(variables, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    bn = ops.BatchNorm(6).train()
    _close(bn(torch.from_numpy(x)), want, OP_OF_MAX, "bn train")
    _close(bn.running_mean, mut["batch_stats"]["mean"], OP_OF_MAX, "mean")
    _close(bn.running_var, mut["batch_stats"]["var"], OP_OF_MAX, "var")


def test_bn_free_conv_seq_3d_raises():
    """A BN-free sequence on 5-D input has no kernel (the chain kernel is 2D)
    and no registered experiment builds one: it raises on every device, here
    on the CPU (``chip_smoke.py`` phase 10 checks the card). With BatchNorm
    the same 3D sequence runs."""
    x = torch.from_numpy(_np(np.random.default_rng(8), 1, 6, 5, 7, 3))
    with pytest.raises(NotImplementedError, match="BN-free 3D"):
        ops.ConvSeq(3, 4, 2, ndim=3)(x)
    assert ops.ConvSeq(3, 4, 2, norm=True, ndim=3)(x).shape == (1, 6, 5, 7, 4)


@pytest.fixture(scope="module")
def rev3d():
    """A 3D ReversibleSequence (1x1 initial conv 3 -> 8, 2 coupling blocks of
    4 + 4 channels) in JAX, its train-mode output, running statistics and
    gradients, and its eval-mode output, op by op."""
    rng = np.random.default_rng(9)
    x = _np(rng, 2, 5, 6, 4, 3)
    jmod = jops.ReversibleSequence(8, depth=2)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), train=True)
    stats = _perturbed_stats(variables, 10)
    params = jax.device_get(variables["params"])
    g = _np(rng, 2, 5, 6, 4, 8)

    def f(p):
        y, mut = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (y, new_stats)), grads = jax.value_and_grad(f, has_aux=True)(params)
    y_eval = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    return dict(x=x, g=g, params=params, stats=stats, y=y, new_stats=jax.device_get(new_stats),
                grads=jax.device_get(grads), y_eval=y_eval)


def _port_rev(r):
    seq = ops.ReversibleSequence(3, 8, depth=2, ndim=3)
    assert seq.block0_f_kernel.shape == (4, 4, 3, 3, 3)
    return load_jax_params(seq, r["params"], r["stats"])


def test_reversible_sequence_3d_train_matches_jax(rev3d):
    seq = _port_rev(rev3d).train()
    x = torch.from_numpy(rev3d["x"]).requires_grad_()
    y = seq(x)
    (y * torch.from_numpy(rev3d["g"])).sum().backward()
    _close(y, rev3d["y"], SEQ_OF_MAX, "rev y")
    want = state_dict_from_jax(rev3d["grads"], seq, rev3d["new_stats"])
    for name, p in seq.named_parameters():
        if name.endswith("_bias") or name == "initial_conv.conv.bias":
            assert not p.grad.any() and not want[name].any(), name
        else:
            _close(p.grad, want[name], SEQ_OF_MAX, name)
    for name, b in seq.named_buffers():
        _close(b, want[name], OP_OF_MAX, name)


def test_reversible_sequence_3d_eval_and_bias_fan_in(rev3d):
    seq = _port_rev(rev3d).eval()
    with torch.no_grad():
        _close(seq(torch.from_numpy(rev3d["x"])), rev3d["y_eval"], SEQ_OF_MAX, "rev eval")
    # the torch_default bias bound is 1/sqrt(3**3 * C/2), as in the JAX module
    fresh = ops.ReversibleSequence(8, 8, depth=3, ndim=3, generator=torch.Generator().manual_seed(0))
    biases = torch.cat([getattr(fresh, f"block{i}_{fg}_bias") for i in range(3) for fg in "fg"])
    bound = 1 / np.sqrt(27 * 4)
    assert biases.abs().max() <= bound and biases.abs().max() > 0.5 * bound
