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


# ---------------------------------------------------------------------------
# FusedConvChain: the CUDA path's backward, run here with each kernel launch
# replaced by the plain stage under no_grad, so autograd cannot see through
# the forward and the gradients are the Function's own
# ---------------------------------------------------------------------------

# f32: both sides take library conv gradients in f32, in other summation
# orders (8.2e-7 of max|grad| at worst measured on the CPU)
GRAD_F32_RTOL_OF_MAX = 1e-5
# bf16: both round the cotangent into each conv and each conv's output to
# bf16 at the same points; the sums may round differently: 2 bf16 ulps of
# max|grad| (0 measured on the CPU)
GRAD_BF16_RTOL_OF_MAX = 2 * 2.0 ** -8


def _plain_stage(x, packed, bias):
    """One stage read from the packed layout; in float32 from both tf32
    halves, whose sum is exact in f32 and within 2^-22 of the kernel."""
    co, ci = bias.shape[0], x.shape[-1]
    kernel = packed[0] + packed[1] if x.dtype == torch.float32 else packed
    kernel = kernel[:co, :, :, :ci].permute(0, 3, 1, 2)
    with torch.no_grad():
        return torch.relu(conv_chain.conv2d_nhwc(x, kernel, bias, padding=1))


def _jax_chain_grads(x, ks, bs, g, dtype):
    """jax.grad of sum(chain(x) * g) for the chain of the JAX package's
    BN-free ``ConvBNAct`` (the stages of its ``ConvSeq``, which the kernel
    chain replaces; one per stage here, since the stages' widths differ),
    with respect to x and the params."""
    import jax

    from unet_zoo_tpu.ops.conv import ConvBNAct as JaxConvBNAct

    stages = [JaxConvBNAct(k.shape[-1], norm=False, dtype=dtype) for k in ks]

    def f(x, params):
        y = jnp.asarray(x, dtype)
        for stage, p in zip(stages, params):
            y = stage.apply({"params": {"conv": p}}, y, train=True)
        return jnp.sum(y.astype(jnp.float32) * g)

    params = [{"kernel": jnp.asarray(k), "bias": jnp.asarray(b)} for k, b in zip(ks, bs)]
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    return (np.asarray(gx), [np.asarray(p["kernel"]).transpose(3, 2, 0, 1) for p in gp],
            [np.asarray(p["bias"]) for p in gp])


def _function_grads(x, ks, bs, g, dtype):
    tx, tks, tbs = _torch_args(x, [k for k in ks], bs)
    tx = tx.requires_grad_()
    params = [t.requires_grad_() for kb in zip(tks, tbs) for t in kb]
    packed = [conv_chain.pack_kernel(k, dtype) for k in tks]
    out = conv_chain.FusedConvChain.apply(tx.to(dtype), packed, *params)
    assert out.dtype == dtype
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in params)
    return tx.grad.numpy(), [k.grad.numpy() for k in tks], [b.grad.numpy() for b in tbs]


def _assert_grads_close(got, want, rtol_of_max):
    for name, g_list, w_list in zip(("x", "kernel", "bias"), got, want):
        for j, (a, b) in enumerate(zip(*((g_list, w_list) if name != "x" else ([g_list], [w_list])))):
            assert a.shape == b.shape, (name, j, a.shape, b.shape)
            scale = np.abs(b).max()
            assert scale > 0, (name, j)
            err = np.abs(a - b).max()
            assert err <= rtol_of_max * scale, (name, j, err, scale)


@pytest.mark.parametrize("shape,chans", SHAPES)
def test_function_backward_matches_jax_grad_f32(monkeypatch, shape, chans):
    monkeypatch.setattr(conv_chain, "_launch_stage", _plain_stage)
    x, ks, bs = _inputs(shape, chans, seed=2)
    g = np.random.default_rng(3).standard_normal((*shape[:3], chans[-1][1])).astype(np.float32)
    before = conv_chain.launches
    got = _function_grads(x, ks, bs, g, torch.float32)
    assert conv_chain.launches == before  # the backward launches no kernel
    _assert_grads_close(got, _jax_chain_grads(x, ks, bs, g, jnp.float32), GRAD_F32_RTOL_OF_MAX)


def test_function_backward_matches_jax_grad_bf16(monkeypatch):
    monkeypatch.setattr(conv_chain, "_launch_stage", _plain_stage)
    shape, chans = SHAPES[0]
    x, ks, bs = _inputs(shape, chans, seed=4)
    g = np.random.default_rng(5).standard_normal((*shape[:3], chans[-1][1])).astype(np.float32)
    got = _function_grads(x, ks, bs, g, torch.bfloat16)
    _assert_grads_close(got, _jax_chain_grads(x, ks, bs, g, jnp.bfloat16), GRAD_BF16_RTOL_OF_MAX)


def test_function_matches_plain_autograd(monkeypatch):
    """Same inputs through the Function and through autograd of the plain
    version: equal gradients, and none for the packed weights."""
    monkeypatch.setattr(conv_chain, "_launch_stage", _plain_stage)
    x, ks, bs = _inputs(*SHAPES[3], seed=6)
    tx, tks, tbs = _torch_args(x, ks, bs)
    leaves = [tx, *tks, *tbs]
    for t in leaves:
        t.requires_grad_()
    packed = [conv_chain.pack_kernel(k, torch.float32) for k in tks]
    out = conv_chain.FusedConvChain.apply(tx, packed, *(t for kb in zip(tks, tbs) for t in kb))
    got = torch.autograd.grad(out.square().sum(), leaves)
    want = torch.autograd.grad(fused_conv_chain_reference(tx, tks, tbs).square().sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
    assert not any(p.requires_grad for p in packed)


# ---------------------------------------------------------------------------
# The bf16 kernel's launch plan and weight layout (Python, so that the CPU
# reaches what surrounds the kernel; the kernel checks the plan it is given)
# ---------------------------------------------------------------------------

# the 7 U-Net blocks at full width: (spatial size, C_in after the concat, C_out)
_BLOCKS = [(128, 1, 32), (64, 32, 64), (32, 64, 128), (16, 128, 192), (32, 320, 128), (64, 192, 64), (128, 96, 32)]
# the 21 stages of the main path at the forward's and the train step's batch
MAIN_STAGES = [(batch, size, cin, co) for batch in (512, 64) for size, ci, co in _BLOCKS for cin in (ci, co, co)]
# chip_smoke.py's test and edge shapes, stage by stage: (x shape, C_out)
EDGE_STAGES = [
    ((2, 16, 16, 4), 8), ((2, 16, 16, 8), 8), ((1, 8, 8, 2), 4), ((3, 20, 12, 4), 4), ((3, 20, 12, 4), 6),
    ((1, 33, 17, 3), 5), ((1, 33, 17, 5), 5), ((1, 33, 17, 5), 2), ((1, 1, 1, 37), 100), ((2, 5, 40, 9), 65),
    ((2, 5, 40, 65), 3), ((1, 17, 3, 16), 64), ((1, 17, 3, 64), 33), ((1, 13, 21, 96), 192),
    ((1, 13, 21, 192), 5), ((2, 19, 35, 1), 32), ((2, 19, 35, 32), 200),
]


def _assert_plan_fits_the_card(p, ci, co):
    assert p.smem_bytes <= conv_chain.SMEM_LIMIT
    assert all(0 < d <= conv_chain.TMA_BOX_MAX for d in p.halo_box + p.weight_box)
    # TMA takes global strides in multiples of 16 bytes: the input's pixel
    # stride where the halo comes by TMA, the packed weights' row always
    if p.loader == "tma":
        assert ci * 2 % 16 == 0
    else:
        assert ci * 2 % 16 != 0
    assert 9 * p.ci_pad * 2 % 16 == 0
    assert p.chunk in (16, 32, 64) and p.ci_pad % p.chunk == 0 and p.ci_pad - ci < p.chunk
    assert p.block_n in (32, 64, 128, 192) and p.co_pad >= co
    assert p.tile_h in (4, 8) and p.threads == 32 * p.tile_h + 32  # a consumer warp an output row
    assert 2 <= p.halo_stages <= 4
    if p.resident:
        assert p.weight_stages == 9 * p.ci_pad // p.chunk and p.block_n >= co
        assert 2 * (p.smem_bytes + 1024) <= conv_chain.SMEM_LIMIT + 2048  # two blocks an SM
    else:
        assert 2 <= p.weight_stages <= 8


@pytest.mark.parametrize("batch,size,ci,co", MAIN_STAGES)
def test_launch_plan_of_the_main_path(batch, size, ci, co):
    p = conv_chain.launch_plan((batch, size, size, ci), co)
    _assert_plan_fits_the_card(p, ci, co)
    assert p.block_n >= co  # all of C_out in one block: the halo is fetched once a tile
    # the grid is persistent (the launcher caps it at the blocks resident at
    # once), and the work items alone fill the card's SMs
    assert p.items >= conv_chain.SM_COUNT
    assert p.loader == ("plain" if ci == 1 else "tma")


@pytest.mark.parametrize("shape,co", EDGE_STAGES)
def test_launch_plan_of_the_edges(shape, co):
    p = conv_chain.launch_plan(shape, co)
    _assert_plan_fits_the_card(p, shape[-1], co)
    batch, height, width, _ = shape
    assert p.items == batch * -(-height // p.tile_h) * -(-width // conv_chain.TILE_W) * -(-co // p.block_n)
    # grids that cannot fill the card take the smaller tile: one consumer warpgroup
    assert p.tile_h == 4 and p.threads == 160


@pytest.mark.parametrize("choice", [{"tile_h": 4}, {"halo_stages": 2}, {"resident": False}])
@pytest.mark.parametrize("batch,size,ci,co", MAIN_STAGES[:21])
def test_launch_plan_takes_other_choices(choice, batch, size, ci, co):
    """The other plans that tools/torch_conv_chain_stages.py --plans times:
    each keeps the choice it was given and still fits the card, and a choice
    that is the plan's own gives the plan itself."""
    shape = (batch, size, size, ci)
    own = conv_chain.launch_plan(shape, co)
    p = conv_chain.launch_plan(shape, co, **choice)
    _assert_plan_fits_the_card(p, ci, co)
    assert all(getattr(p, key) == value for key, value in choice.items())
    if all(getattr(own, key) == value for key, value in choice.items()):
        assert p == own


def test_launch_plan_takes_the_plain_loader_for_a_misaligned_input():
    assert conv_chain.launch_plan((2, 16, 16, 64), 64, aligned=True).loader == "tma"
    assert conv_chain.launch_plan((2, 16, 16, 64), 64, aligned=False).loader == "plain"


@pytest.mark.parametrize("ci", [1, 9, 16, 32, 37, 64, 96, 192, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_kernel_round_trip(ci, dtype):
    """The packed layout (C_out_pad, 3, 3, C_in_pad) holds whole K chunks of
    the kernel of its dtype and gives back the OIHW kernel, zeros elsewhere:
    in bf16 the kernel itself; in float32 twice, its tf32 hi and lo halves
    (``split_tf32``), whose sum gives it back within 2^-22 of each value."""
    co = 33
    k = torch.from_numpy(np.random.default_rng(ci).standard_normal((co, ci, 3, 3)).astype(np.float32))
    packed = conv_chain.pack_kernel(k, dtype)
    assert packed.shape == conv_chain.packed_shape(co, ci, dtype) and packed.dtype == dtype
    n, c, tap = 5, ci - 1, 7
    if dtype == torch.float32:
        chunk = conv_chain.f32_chunk_width(ci)
        assert chunk == min(c for c in (8, 16, 32) if c >= min(ci, 32))
        assert packed.shape == (2, 64, 3, 3, conv_chain.f32_padded_ci(ci))
        assert packed.shape[-1] == conv_chain.f32_launch_plan((1, 8, 8, ci), co).ci_pad
        hi, lo = conv_chain.split_tf32(k)
        halves = packed[:, :co, :, :, :ci].permute(0, 1, 4, 2, 3)
        torch.testing.assert_close(halves[0], hi, rtol=0, atol=0)
        torch.testing.assert_close(halves[1], lo, rtol=0, atol=0)
        assert ((halves[0] + halves[1] - k).abs() <= 2.0 ** -22 * k.abs()).all()
        assert not packed[:, co:].any() and not packed[..., ci:].any()
        expect = hi[n, c, tap // 3, tap % 3]
        packed = packed[0]  # the hi half, as its TMA box reads it
    else:
        chunk = conv_chain.chunk_width(ci)
        assert chunk == min(c for c in (16, 32, 64) if c >= min(ci, 64))
        assert packed.shape == (64, 3, 3, conv_chain.padded_ci(ci))
        assert packed.shape[-1] == conv_chain.launch_plan((1, 8, 8, ci), co).ci_pad
        torch.testing.assert_close(packed[:co, :, :, :ci].permute(0, 3, 1, 2), k.to(dtype), rtol=0, atol=0)
        assert not packed[co:].any() and not packed[:, :, :, ci:].any()
        expect = k[n, c, tap // 3, tap % 3].to(dtype)
    assert packed.shape[-1] % chunk == 0 and packed.shape[-1] - ci < chunk
    # viewed as the weights' TMA tensor (C_out_pad, 9 * C_in_pad), K-major:
    # row n, column tap * C_in_pad + c is k[n, c, tap // 3, tap % 3]
    rows = packed.reshape(64, -1)
    assert rows[n, tap * packed.shape[-1] + c] == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stage_slices_the_packed_layout(dtype):
    """The test helper that stands in for a launch reads the packed layout as
    the kernel does: in bf16 one full and one partial 64-channel chunk, in
    float32 three 32-channel chunks of both tf32 halves, whose sum is the
    kernel the plain version then runs."""
    x, ks, bs = _torch_args(*_inputs((1, 9, 11, 96), [(96, 40)], seed=7), dtype)
    packed = conv_chain.pack_kernel(ks[0], dtype)
    assert packed.shape == ((2, 64, 3, 3, 96) if dtype == torch.float32 else (64, 3, 3, 128))
    if dtype == torch.float32:
        ks = [sum(conv_chain.split_tf32(ks[0]))]
    torch.testing.assert_close(_plain_stage(x, packed, bs[0]), fused_conv_chain_reference(x, ks, bs),
                               rtol=0, atol=0)
