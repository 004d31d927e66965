"""The port's U-Net against the JAX U-Net on the same weights.

The JAX model is initialised, its params carried across with
``unet_zoo_tpu_torch.bridge``, and both run on the same numpy inputs. On the
CPU the port's blocks take the conv chain's plain version.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models.blocks import DownBlock as JaxDownBlock
from unet_zoo_tpu.models.registry import get_model as jax_get_model
from unet_zoo_tpu.models.unet import UNet as JaxUNet
from unet_zoo_tpu_torch import ops
from unet_zoo_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from unet_zoo_tpu_torch.models.blocks import DownBlock
from unet_zoo_tpu_torch.models.registry import get_model
from unet_zoo_tpu_torch.models.unet import UNet, softmax_cross_entropy

FILTERS = (4, 8, 8, 8)
# f32: same math, other summation order, through 22 convs
F32_RTOL = F32_ATOL = 1e-4
# bf16: both cast at the same points, but the JAX model rounds each half of
# the implicit concat's conv separately and the port concatenates first, so
# values may differ by a few bf16 ulps (2^-8 relative) of max|logits|
BF16_ATOL_OF_MAX = 4 * 2.0 ** -8
BF16_ARGMAX_AGREEMENT = 0.99


def _pair(hw, jax_dtype=None, torch_dtype=None, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, *hw, 1)).astype(np.float32)
    jmodel = jax_get_model("unet", num_classes=2, num_filters=FILTERS, dtype=jax_dtype)
    variables = jmodel.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x), train=False)
    tmodel = get_model("unet", num_classes=2, num_filters=FILTERS, dtype=torch_dtype, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    load_jax_params(tmodel, jax.device_get(variables["params"]))
    return x, jmodel, variables, tmodel


@pytest.mark.parametrize("hw", [(32, 32), (33, 17)])
def test_logits_match_jax_f32(hw):
    x, jmodel, variables, tmodel = _pair(hw)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, 2)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("hw", [(32, 32), (33, 17)])
def test_logits_match_jax_bf16(hw):
    x, jmodel, variables, tmodel = _pair(hw, jnp.bfloat16, torch.bfloat16, seed=1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False).astype(jnp.float32))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= BF16_ATOL_OF_MAX * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= BF16_ARGMAX_AGREEMENT


def test_up_block_concat_order_matches_jax():
    """(upsampled, skip) is concatenated upsampled first; the reverse order
    gives a plausible output that this pins down."""
    rng = np.random.default_rng(2)
    up, skip = rng.standard_normal((2, 9, 7, 6)).astype(np.float32), rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    jblock = JaxDownBlock(5, pool=False)
    variables = jblock.init(jax.random.PRNGKey(0), (jnp.asarray(up), jnp.asarray(skip)), train=False)
    want = np.asarray(jblock.apply(variables, (jnp.asarray(up), jnp.asarray(skip)), train=False))
    tblock = load_jax_params(DownBlock(9, 5, pool=False), jax.device_get(variables["params"]))
    with torch.inference_mode():
        got = tblock((torch.from_numpy(up), torch.from_numpy(skip))).numpy()
        swapped = tblock.convs(torch.from_numpy(np.concatenate([skip, up], -1))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not np.allclose(swapped, want, atol=1e-2)


def test_loss_sample_accumulate_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 5)).astype(np.int32)
    jl, jaux = JaxUNet.loss(jnp.asarray(logits), jnp.asarray(labels))
    tl, taux = UNet.loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert set(taux) == set(jaux) and taux["kl"].item() == 0.0
    np.testing.assert_allclose(
        softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jax.nn.log_softmax(logits, -1) * -jax.nn.one_hot(labels, 3)).sum(-1), rtol=1e-6)
    for use_softmax in (False, True):
        np.testing.assert_allclose(
            UNet.accumulate_output(torch.from_numpy(logits), use_softmax).numpy(),
            np.asarray(JaxUNet.accumulate_output(jnp.asarray(logits), use_softmax)), rtol=1e-6)

    x, jmodel, variables, tmodel = _pair((16, 16))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), 3, method=jmodel.sample))
    with torch.inference_mode():
        got = tmodel.sample(torch.from_numpy(x), 3).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16, 2)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_gradient_matches_jax(dtype):
    """The port's gather CE against the JAX one-hot contraction: the
    gradient with respect to the logits, softmax minus one-hot over the
    pixel count, in the logits' dtype."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 5)).astype(np.int32)
    jl = jnp.asarray(logits, dtype)
    want = jax.grad(lambda a: JaxUNet.loss(a, jnp.asarray(labels))[0])(jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    UNet.loss(tl, torch.from_numpy(labels))[0].backward()
    assert tl.grad.dtype == tl.dtype
    # f32: the same sums; bf16: the gradient is rounded once to bf16 on both sides
    np.testing.assert_allclose(tl.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "float32" else 2.0 ** -8, atol=1e-9)


def test_bridge_checks_keys_and_shapes():
    x = np.zeros((1, 16, 16, 1), np.float32)
    params = jax.device_get(
        jax_get_model("unet", num_classes=2, num_filters=FILTERS)
        .init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)["params"])
    model = UNet(2, FILTERS)
    assert set(state_dict_from_jax(params, model)) == set(model.state_dict())
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax({k: v for k, v in params.items() if k != "last"}, model)
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_jax({**params, "head": {"kernel": np.zeros((1, 1, 4, 2))}}, model)
    with pytest.raises(ValueError, match="last.weight"):
        state_dict_from_jax({**params, "last": {**params["last"], "kernel": np.zeros((1, 1, 4, 3))}}, model)


def test_registry_and_unported_modes():
    assert isinstance(get_model("unet", num_classes=2, num_filters=FILTERS, device="cpu"), UNet)
    phiseg3d = get_model("phiseg3d", num_classes=3, num_filters=(2, 4), latent_levels=1, image_size=(4, 4, 4),
                         reversible_mode="reversible", device="cpu")
    assert phiseg3d.prior.down0.rev.depth == 1 and phiseg3d.prior.down0.rev.block0_f_kernel.shape == (1, 1, 3, 3, 3)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("resnet")
    assert isinstance(UNet(2, FILTERS, reversible_mode="reversible").down0.rev, ops.ReversibleSequence)
    with pytest.raises(ValueError, match="memory mode"):
        UNet(2, FILTERS, reversible_mode="revnet")


def test_same_seed_same_weights():
    a = UNet(2, FILTERS, generator=torch.Generator().manual_seed(5)).state_dict()
    b = UNet(2, FILTERS, generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_port_never_imports_jax():
    # a subprocess: this test process has jax imported by tests/conftest.py.
    # Nor h5py, scikit-learn, OpenCV or PIL at import: the card's machine has none of them.
    code = ("import sys, unet_zoo_tpu_torch, unet_zoo_tpu_torch.models.registry, "
            "unet_zoo_tpu_torch.bridge, unet_zoo_tpu_torch.ops.pallas._build, "
            "unet_zoo_tpu_torch.data, unet_zoo_tpu_torch.data.augment, "
            "unet_zoo_tpu_torch.data.batch_provider, unet_zoo_tpu_torch.data.lidc, "
            "unet_zoo_tpu_torch.data.registry, unet_zoo_tpu_torch.data.synthetic, unet_zoo_tpu_torch.data.brats, "
            "unet_zoo_tpu_torch.data.uzh, "
            "unet_zoo_tpu_torch.metrics.brats, unet_zoo_tpu_torch.utils.nii, unet_zoo_tpu_torch.utils.postprocess, "
            "unet_zoo_tpu_torch.experiments, unet_zoo_tpu_torch.experiments.config, "
            "unet_zoo_tpu_torch.experiments.registry, unet_zoo_tpu_torch.training, "
            "unet_zoo_tpu_torch.training.schedule, unet_zoo_tpu_torch.training.state, "
            "unet_zoo_tpu_torch.training.trainer, unet_zoo_tpu_torch.training.cli, "
            "unet_zoo_tpu_torch.models.phiseg, unet_zoo_tpu_torch.models.prob_unet, unet_zoo_tpu_torch.ops.norm, "
            "unet_zoo_tpu_torch.ops.reversible, unet_zoo_tpu_torch.parallel, unet_zoo_tpu_torch.parallel.mesh, "
            "unet_zoo_tpu_torch.parallel.space, "
            "unet_zoo_tpu_torch.metrics, unet_zoo_tpu_torch.metrics.dice, unet_zoo_tpu_torch.metrics.ged, "
            "unet_zoo_tpu_torch.metrics.ncc, unet_zoo_tpu_torch.utils, unet_zoo_tpu_torch.utils.summary, "
            "unet_zoo_tpu_torch.train, unet_zoo_tpu_torch.eval, unet_zoo_tpu_torch.data.cache, "
            "unet_zoo_tpu_torch.data.augment_host, unet_zoo_tpu_torch.native, unet_zoo_tpu_torch.native.store, "
            "unet_zoo_tpu_torch.utils.profiling, unet_zoo_tpu_torch.utils.png; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'triton', 'unet_zoo_tpu', 'h5py', 'sklearn', 'cv2', 'PIL')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
