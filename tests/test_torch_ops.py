"""The port's ops against the JAX package's, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from unet_zoo_tpu import ops as jops
from unet_zoo_tpu.ops import init as jinit
from unet_zoo_tpu.ops.norm import BatchNorm as JaxBatchNorm
from unet_zoo_tpu.training.trainer import adam_coupled_l2 as jax_adam_coupled_l2
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import load_jax_params
from unet_zoo_tpu_torch.ops import init as tinit
from unet_zoo_tpu_torch.ops.pallas.conv_chain import pack_kernel


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class TestPool:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 7, 5, 3), (1, 9, 4, 2)])
    def test_avg_pool_ceil_matches_jax(self, shape):
        x = _np(np.random.default_rng(0), *shape)
        got = ops.avg_pool_ceil(torch.from_numpy(x)).numpy()
        want = np.asarray(jops.avg_pool_ceil(jnp.asarray(x)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)

    @pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 7, 5, 3)])
    def test_avg_pool_ceil_grad_matches_jax_vjp(self, shape):
        """autograd of F.avg_pool2d against the JAX op's custom VJP (its
        pre-transposed averaging matrices), edge windows of 1 included."""
        rng = np.random.default_rng(10)
        x = _np(rng, *shape)
        y, vjp = jax.vjp(jops.avg_pool_ceil, jnp.asarray(x))
        g = _np(rng, *y.shape)
        tx = torch.from_numpy(x).requires_grad_()
        ops.avg_pool_ceil(tx).backward(torch.from_numpy(g))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6)

    def test_rejects_non_nhwc(self):
        with pytest.raises(ValueError):
            ops.avg_pool_ceil(torch.zeros(2, 4, 4))


class TestResize:
    @pytest.mark.parametrize("align", [False, True])
    @pytest.mark.parametrize("shape,out", [
        ((1, 33, 17, 2), (17, 9)),
        ((1, 17, 9, 2), (33, 17)),
        ((2, 8, 8, 3), (16, 16)),
    ])
    def test_resize_linear_matches_jax(self, shape, out, align):
        x = _np(np.random.default_rng(1), *shape)
        got = ops.resize_linear(torch.from_numpy(x), out, align_corners=align).numpy()
        want = np.asarray(jops.resize_linear(jnp.asarray(x), out, align_corners=align))
        assert got.shape == want.shape == (shape[0], *out, shape[-1])
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("align", [False, True])
    @pytest.mark.parametrize("shape,out", [((2, 8, 8, 3), (16, 16)), ((1, 17, 9, 2), (33, 17))])
    def test_resize_linear_grad_matches_jax_vjp(self, shape, out, align):
        """autograd of F.interpolate against the JAX op's custom VJP."""
        rng = np.random.default_rng(11)
        x, g = _np(rng, *shape), _np(rng, shape[0], *out, shape[-1])
        _, vjp = jax.vjp(lambda a: jops.resize_linear(a, out, align_corners=align), jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        ops.resize_linear(tx, out, align_corners=align).backward(torch.from_numpy(g))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)

    def test_upsample_nearest_grad_matches_jax_vjp(self):
        rng = np.random.default_rng(12)
        x, g = _np(rng, 2, 8, 8, 4), _np(rng, 2, 50, 30, 4)
        _, vjp = jax.vjp(lambda a: jops.upsample_nearest(a, (50, 30)), jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        ops.upsample_nearest(tx, (50, 30)).backward(torch.from_numpy(g))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)

    @pytest.mark.parametrize("out", [(16, 16), (50, 30)])
    def test_upsample_nearest_matches_jax(self, out):
        x = _np(np.random.default_rng(2), 2, 8, 8, 4)
        got = ops.upsample_nearest(torch.from_numpy(x), out).numpy()
        want = np.asarray(jops.upsample_nearest(jnp.asarray(x), out))
        np.testing.assert_array_equal(got, want)


class TestConv:
    def _pair(self, cin, features, kernel_size, dtype=None):
        jmod = jops.Conv(features, kernel_size, init_scheme="he_normal",
                         dtype=None if dtype is None else jnp.bfloat16)
        tmod = ops.Conv(cin, features, kernel_size, init_scheme="he_normal",
                        dtype=dtype, generator=torch.Generator().manual_seed(0))
        return jmod, tmod

    def test_tuple_input_is_a_channel_concat(self):
        rng = np.random.default_rng(3)
        a, b = _np(rng, 2, 9, 7, 3), _np(rng, 2, 9, 7, 2)
        jmod, tmod = self._pair(5, 4, 3)
        variables = jmod.init(jax.random.PRNGKey(0), (jnp.asarray(a), jnp.asarray(b)))
        want = np.asarray(jmod.apply(variables, (jnp.asarray(a), jnp.asarray(b))))
        load_jax_params(tmod, jax.device_get(variables["params"]))
        got = tmod((torch.from_numpy(a), torch.from_numpy(b))).detach().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        whole = tmod(torch.from_numpy(np.concatenate([a, b], -1))).detach().numpy()
        np.testing.assert_array_equal(got, whole)

    @pytest.mark.parametrize("kernel_size", [1, 3])
    def test_padding_rule_matches_jax(self, kernel_size):
        x = _np(np.random.default_rng(4), 2, 6, 5, 3)
        jmod, tmod = self._pair(3, 2, kernel_size)
        variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
        load_jax_params(tmod, jax.device_get(variables["params"]))
        got = tmod(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape == (2, 6, 5, 2)  # k=3 -> pad 1, k=1 -> pad 0
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_bf16_cast_points_match_jax(self):
        # both cast operands to bf16, add the bias in f32 and round once more;
        # the conv sums may round differently: 2 bf16 ulps of max|ref|
        x = _np(np.random.default_rng(5), 2, 8, 8, 4)
        jmod, tmod = self._pair(4, 8, 3, dtype=torch.bfloat16)
        variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)).astype(jnp.float32))
        load_jax_params(tmod, jax.device_get(variables["params"]))
        got = tmod(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().detach().numpy() - want).max()
        assert err <= 2 * 2.0 ** -8 * np.abs(want).max()

    def test_conv_seq_chain_is_its_layers_in_order(self):
        x = torch.from_numpy(_np(np.random.default_rng(6), 2, 7, 6, 3))
        seq = ops.ConvSeq(3, 4, 3, generator=torch.Generator().manual_seed(0))
        want = x
        with torch.inference_mode():
            for layer in seq.children():
                want = torch.relu(layer.conv(want))
            torch.testing.assert_close(seq(x), want)

    def test_pack_kernel_layout(self):
        k = torch.from_numpy(_np(np.random.default_rng(7), 37, 5, 3, 3))
        w = pack_kernel(k, torch.bfloat16)
        # C_out 37 -> 64, C_in 5 -> 16, zero past both
        assert w.shape == (64, 3, 3, 16) and w.dtype == torch.bfloat16 and w.is_contiguous()
        assert torch.equal(w[:37, :, :, :5], k.permute(0, 2, 3, 1).to(torch.bfloat16))
        assert not w[37:].any() and not w[:, :, :, 5:].any()

    def test_conv_seq_packs_once_per_parameter_version(self):
        """The packed buffers are allocated once per (dtype, device) and
        refilled on every call, so they follow every parameter update, also
        one that does not bump ``_version`` (as fused Adam's does not)."""
        seq = ops.ConvSeq(3, 4, 2, generator=torch.Generator().manual_seed(0))
        weights = [m.conv.weight for m in seq.children()]
        first = seq._packed_kernels(weights, torch.float32)
        ptrs = [t.data_ptr() for t in first]
        assert [t.data_ptr() for t in seq._packed_kernels(weights, torch.float32)] == ptrs
        bf16 = seq._packed_kernels(weights, torch.bfloat16)
        assert bf16[0].dtype == torch.bfloat16 and bf16[0].data_ptr() not in ptrs
        seq.load_state_dict({k: v + 1 for k, v in seq.state_dict().items()})
        repacked = seq._packed_kernels(weights, torch.bfloat16)
        assert torch.equal(repacked[0], pack_kernel(weights[0], torch.bfloat16))
        version = weights[1]._version
        weights[1].data.mul_(2)
        assert weights[1]._version == version
        assert torch.equal(seq._packed_kernels(weights, torch.float32)[1], pack_kernel(weights[1], torch.float32))

    def test_packed_kernels_refill_after_inference_mode(self):
        """Buffers first packed under inference_mode (an evaluation) are
        refilled by a later forward outside it (a train step)."""
        seq = ops.ConvSeq(3, 4, 2, generator=torch.Generator().manual_seed(3))
        weights = [m.conv.weight for m in seq.children()]
        with torch.inference_mode():
            first = seq._packed_kernels(weights, torch.float32)
        assert not any(t.is_inference() for t in first)
        with torch.no_grad():
            weights[0].add_(1)
        again = seq._packed_kernels(weights, torch.float32)
        assert again[0].data_ptr() == first[0].data_ptr()
        assert torch.equal(again[0], pack_kernel(weights[0], torch.float32))

    @pytest.mark.parametrize("optimizer", ["fused", "foreach", "trainer"])
    def test_packed_kernels_follow_an_adam_step(self, optimizer):
        from unet_zoo_tpu_torch.training import adam_coupled_l2

        seq = ops.ConvSeq(3, 4, 3, generator=torch.Generator().manual_seed(1))
        weights = [m.conv.weight for m in seq.children()]
        before = [t.clone() for t in seq._packed_kernels(weights, torch.float32)]
        gen = torch.Generator().manual_seed(2)
        for p in seq.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        if optimizer == "trainer":
            opt = adam_coupled_l2(seq.parameters(), 1e-2, 1e-5)
        else:
            opt = torch.optim.Adam(seq.parameters(), lr=1e-2, weight_decay=1e-5, **{optimizer: True})
        opt.step()
        for b, a, w in zip(before, seq._packed_kernels(weights, torch.float32), weights):
            assert not torch.equal(a, b)
            assert torch.equal(a, pack_kernel(w, torch.float32))


class TestBatchNorm:
    """The port's BatchNorm (``F.batch_norm`` on the f32 input, Welford
    variance) against the JAX module (one-pass variance): float32 rounding
    apart, in f32 and bf16, train and eval mode, with the running update."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("train", [True, False])
    def test_matches_jax(self, dtype, train):
        rng = np.random.default_rng(20)
        x = (_np(rng, 2, 7, 5, 6) * 2 + 1).astype(np.float32)  # mean 1, std 2
        scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), _np(rng, 6)
        mean, var = _np(rng, 6), rng.uniform(0.5, 2.0, 6).astype(np.float32)
        variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
        jx = jnp.asarray(x, dtype)
        want, mut = JaxBatchNorm().apply(variables, jx, use_running_average=not train, mutable=["batch_stats"])
        bn = load_jax_params(ops.BatchNorm(6), variables["params"], variables["batch_stats"]).train(train)
        got = bn(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        # f32: rounding; bf16: both round the same f32 value once, 1 ulp apart at most
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
        stats = mut["batch_stats"] if train else variables["batch_stats"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
        assert not train or not np.allclose(stats["var"], var)  # the update happened

    def test_gradients_match_jax(self):
        rng = np.random.default_rng(21)
        x, g = _np(rng, 3, 4, 5, 4) + 0.5, _np(rng, 3, 4, 5, 4)
        params = {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32), "bias": _np(rng, 4)}
        stats = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}

        def f(p, a):
            y, _ = JaxBatchNorm().apply({"params": p, "batch_stats": stats}, a, use_running_average=False,
                                        mutable=["batch_stats"])
            return jnp.sum(y * g)

        want_p, want_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
        bn = load_jax_params(ops.BatchNorm(4), params, stats)
        tx = torch.from_numpy(x).requires_grad_()
        (bn(tx) * torch.from_numpy(g)).sum().backward()
        for got, want in ((tx.grad, want_x), (bn.weight.grad, want_p["scale"]), (bn.bias.grad, want_p["bias"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * np.abs(np.asarray(want)).max())


class TestConvSeqNorm:
    def test_matches_jax_conv_seq(self):
        """``ConvSeq(norm=True)``: conv + BN + ReLU per layer, the running
        statistics updated in train mode, read in eval mode."""
        rng = np.random.default_rng(22)
        a, b = _np(rng, 2, 9, 7, 3), _np(rng, 2, 9, 7, 2)
        jmod = jops.ConvSeq(5, depth=2)
        variables = jmod.init(jax.random.PRNGKey(0), (jnp.asarray(a), jnp.asarray(b)), train=True)
        want, mut = jmod.apply(variables, (jnp.asarray(a), jnp.asarray(b)), train=True, mutable=["batch_stats"])
        seq = ops.ConvSeq(5, 5, 2, norm=True, init_scheme="torch_default")
        load_jax_params(seq, jax.device_get(variables["params"]), jax.device_get(variables["batch_stats"]))
        got = seq((torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
        for i in range(2):
            np.testing.assert_allclose(getattr(seq, f"conv{i}").bn.running_var.numpy(),
                                       np.asarray(mut["batch_stats"][f"conv{i}"]["bn"]["var"]), rtol=1e-6)
        want_eval = jmod.apply({"params": variables["params"], **mut}, (jnp.asarray(a), jnp.asarray(b)), train=False)
        with torch.no_grad():
            got_eval = seq.eval()((torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=1e-5)

    def test_norm_false_routes_to_the_fused_chain(self, monkeypatch):
        from unet_zoo_tpu_torch.ops import conv

        calls = []
        chain = conv.fused_conv_chain
        monkeypatch.setattr(conv, "fused_conv_chain", lambda *a, **k: calls.append(1) or chain(*a, **k))
        x = torch.from_numpy(_np(np.random.default_rng(23), 1, 6, 6, 3))
        ops.ConvSeq(3, 4, 3)(x)
        assert calls == [1]
        ops.ConvSeq(3, 4, 3, norm=True)(x)
        assert calls == [1]
        assert "conv0.bn.weight" in ops.ConvSeq(3, 4, 1, norm=True).state_dict()
        assert not any("bn" in k for k in ops.ConvSeq(3, 4, 1).state_dict())

    def test_grad_free_bias_takes_the_decay_only_update(self):
        """The bias of a conv that BN follows gets an exact zero gradient (not
        None), so one ``adam_coupled_l2`` step moves it as optax's
        ``add_decayed_weights -> adam`` moves a stop_gradient bias."""
        from unet_zoo_tpu_torch.training import adam_coupled_l2

        layer = ops.ConvBNAct(3, 4, generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(_np(np.random.default_rng(24), 2, 5, 5, 3))
        opt = adam_coupled_l2(layer.parameters(), 1e-3, 1e-5)
        (layer(x) ** 2).sum().backward()
        assert layer.conv.bias.grad is not None and not layer.conv.bias.grad.any()
        assert layer.conv.weight.grad.any()
        p0 = layer.conv.bias.detach().numpy().copy()
        opt.step()
        tx = jax_adam_coupled_l2(1e-3, 1e-5)
        jp = jnp.asarray(p0)
        updates, _ = tx.update(jnp.zeros_like(jp), tx.init(jp), jp)
        want = np.asarray(optax.apply_updates(jp, updates))
        np.testing.assert_allclose(layer.conv.bias.detach().numpy(), want, rtol=2.0 ** -23, atol=1e-4 * 1e-3)
        assert np.all(np.abs(want - p0) > 0.9e-3)  # about lr * sign(p)


class TestInit:
    # OIHW for the port, HWIO for JAX: the same fan_in of 8 * 3 * 3 = 72
    OIHW = (256, 8, 3, 3)
    HWIO = (3, 3, 8, 256)

    def _port(self, fn, shape=OIHW):
        out = fn(shape, torch.Generator().manual_seed(0))
        assert tuple(out.shape) == shape and out.dtype == torch.float32
        return out.numpy()

    def _jax(self, fn, shape=HWIO):
        return np.asarray(fn(jax.random.PRNGKey(0), shape))

    def test_he_normal(self):
        got, want = self._port(tinit.kaiming_normal_fan_in), self._jax(jinit.kaiming_normal_fan_in)
        std = np.sqrt(2.0 / 72)
        # 18432 draws: the sample std is within ~0.5% of the true one
        assert abs(got.std() / std - 1) < 0.03 and abs(want.std() / std - 1) < 0.03
        assert abs(got.mean()) < 0.05 * std

    def test_truncated_normal_bias(self):
        got = self._port(tinit.truncated_normal_std(1e-3), (8192,))
        want = self._jax(jinit.truncated_normal_std(1e-3), (8192,))
        assert np.abs(got).max() <= 2e-3 and np.abs(want).max() <= 2e-3
        # std of a standard normal truncated at +-2 is 0.8796
        assert abs(got.std() / 0.8796e-3 - 1) < 0.05 and abs(want.std() / 0.8796e-3 - 1) < 0.05

    def test_torch_default_kernel_and_bias(self):
        bound = 1 / np.sqrt(72)
        for got, want in [
            (self._port(tinit.torch_default_conv_kernel), self._jax(jinit.torch_default_conv_kernel)),
            (self._port(tinit.torch_default_conv_bias(72), (8192,)),
             self._jax(jinit.torch_default_conv_bias(72), (8192,))),
        ]:
            assert np.abs(got).max() <= bound and np.abs(want).max() <= bound
            assert abs(got.std() / (bound / np.sqrt(3)) - 1) < 0.05
            assert abs(want.std() / (bound / np.sqrt(3)) - 1) < 0.05

    def test_orthogonal(self):
        got = self._port(tinit.orthogonal_kernel, (16, 8, 3, 3)).reshape(16, 72)
        want = self._jax(jinit.orthogonal_kernel, (3, 3, 8, 16)).reshape(72, 16)
        np.testing.assert_allclose(got @ got.T, np.eye(16), atol=1e-5)
        np.testing.assert_allclose(want.T @ want, np.eye(16), atol=1e-5)

    def test_same_seed_same_draws(self):
        a = tinit.kaiming_normal_fan_in((4, 3, 3, 3), torch.Generator().manual_seed(7))
        b = tinit.kaiming_normal_fan_in((4, 3, 3, 3), torch.Generator().manual_seed(7))
        assert torch.equal(a, b)
