"""The port's conv chain against the JAX Pallas kernel (interpret mode).

On the CPU the port's ``fused_conv_chain`` runs its plain version; both it
and ``fused_conv_chain_reference`` are held against the JAX
``fused_conv_chain`` on the same numpy inputs. The CUDA kernel itself is
checked on the card by ``chip_smoke.py``.
"""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.ops.pallas import fused_conv_chain as jax_chain
from unet_zoo_tpu_torch.ops.pallas import conv_chain
from unet_zoo_tpu_torch.ops.pallas.conv_chain import (
    fused_conv_chain,
    fused_conv_chain_reference,
)

# f32: both sides accumulate in f32; the Pallas kernel's im2col sums in
# another order than torch's conv
F32_ATOL = 1e-4
# bf16: the Pallas kernel rounds each stage once (after the f32 bias), the
# port's plain version also rounds the conv output before the bias; allow
# 4 bf16 ulps (2^-8 relative each) of max|ref| over a 3-stage chain
BF16_RTOL_OF_MAX = 4 * 2.0 ** -8

SHAPES = [
    ((2, 16, 16, 4), [(4, 8), (8, 8), (8, 8)]),  # U-Net block shape
    ((1, 8, 8, 2), [(2, 4)]),  # single conv
    ((3, 20, 12, 4), [(4, 4), (4, 6)]),  # non-square, 2 stages
    ((1, 33, 17, 3), [(3, 5), (5, 5), (5, 2)]),  # odd sizes
]


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def wrapper(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", wrapper)
    yield


def _inputs(shape, chans, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, ci, co)) * 0.2).astype(np.float32) for ci, co in chans]
    bs = [rng.standard_normal((co,)).astype(np.float32) for _, co in chans]
    return x, ks, bs


def _run_jax(x, ks, bs, dtype=jnp.float32):
    out = jax_chain(jnp.asarray(x, dtype), [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs])
    return np.asarray(out.astype(jnp.float32))


def _torch_args(x, ks, bs, dtype=torch.float32):
    # HWIO -> OIHW, the port's kernel layout
    return (torch.from_numpy(x).to(dtype), [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in ks],
            [torch.from_numpy(b) for b in bs])


@pytest.mark.parametrize("fn", [fused_conv_chain_reference, fused_conv_chain], ids=["reference", "wrapper"])
@pytest.mark.parametrize("shape,chans", SHAPES)
def test_matches_jax_pallas_f32(fn, shape, chans):
    x, ks, bs = _inputs(shape, chans)
    got = fn(*_torch_args(x, ks, bs)).numpy()
    np.testing.assert_allclose(got, _run_jax(x, ks, bs), atol=F32_ATOL)


@pytest.mark.parametrize("fn", [fused_conv_chain_reference, fused_conv_chain], ids=["reference", "wrapper"])
def test_zero_border_semantics(fn):
    """A constant image exposes any leakage through the zero padding."""
    x = np.ones((1, 12, 12, 3), np.float32)
    ks = [np.full((3, 3, 3, 4), 0.1, np.float32), np.full((3, 3, 4, 4), 0.1, np.float32)]
    bs = [np.zeros(4, np.float32), np.zeros(4, np.float32)]
    got = fn(*_torch_args(x, ks, bs)).numpy()
    np.testing.assert_allclose(got, _run_jax(x, ks, bs), atol=F32_ATOL)


@pytest.mark.parametrize("shape,chans", [SHAPES[0], SHAPES[3]])
def test_matches_jax_pallas_bf16(shape, chans):
    x, ks, bs = _inputs(shape, chans, seed=1)
    got = fused_conv_chain(*_torch_args(x, ks, bs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = _run_jax(x, ks, bs, jnp.bfloat16)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_RTOL_OF_MAX * np.abs(want).max(), (err, np.abs(want).max())


def test_cpu_path_does_not_count_launches():
    x, ks, bs = _inputs(*SHAPES[0])
    before = conv_chain.launches
    fused_conv_chain(*_torch_args(x, ks, bs))
    assert conv_chain.launches == before


@pytest.mark.parametrize("case", ["dtype", "channels", "bias", "stages", "relu_last", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, ks, bs = _torch_args(*_inputs(*SHAPES[0]))
    kwargs = {}
    expected = ValueError
    if case == "dtype":
        x, expected = x.double(), TypeError
    elif case == "channels":
        ks = [ks[0][:, :2]] + ks[1:]
    elif case == "bias":
        bs = [bs[0][:3]] + bs[1:]
    elif case == "stages":
        bs = bs[:-1]
    elif case == "relu_last":
        kwargs, expected = {"relu_last": False}, NotImplementedError
    elif case == "device":
        x, ks, bs = x.to("meta"), [k.to("meta") for k in ks], [b.to("meta") for b in bs]
    with pytest.raises(expected):
        fused_conv_chain(x, ks, bs, **kwargs)
