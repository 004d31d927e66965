"""The port's float32 conv-chain kernel around its CUDA code, on the CPU.

The kernel (``conv3x3_f32_3xtf32_wgmma`` in ``csrc/conv_chain.cu``) runs only
on the card, where ``chip_smoke.py`` holds it against its plain versions.
Here: the tf32 split that ``pack_kernel`` applies to the weights (and the
kernel, with ``cvt.rna.tf32.f32``, to the activations); the plain 3xTF32
version of the kernel's arithmetic against the JAX Pallas chain in float32
(interpret mode); the launch plan at every stage the float32 main path
runs; and ``Trainer``'s float32 precision setting.
"""

import logging

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.ops.pallas import fused_conv_chain as jax_chain
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.ops.pallas import conv_chain
from unet_zoo_tpu_torch.training import Trainer

# max|3xTF32 - JAX f32| <= F32_RTOL * max|JAX f32| (chip_smoke.py's gate for
# the kernel): each product lies ~2^-21 from the f32 one, and the sums run
# in another order than the Pallas kernel's im2col
F32_RTOL = 1e-4

# the shapes of tests/test_torch_conv_chain.py: x shape, [(C_in, C_out) per stage]
SHAPES = [
    ((2, 16, 16, 4), [(4, 8), (8, 8), (8, 8)]),
    ((1, 8, 8, 2), [(2, 4)]),
    ((3, 20, 12, 4), [(4, 4), (4, 6)]),
    ((1, 33, 17, 3), [(3, 5), (5, 5), (5, 2)]),
]

# the float32 main path's stages: ProbUNet's 13 trunk blocks (chip_smoke.py
# PROB_BLOCKS, (size, C_in after the concat, C_out)) at the batches its
# path runs them (a sample, the train step, a validation image's loss
# repeats), and the U-Net's 7 blocks at the f32 step's batch 12
_PROB_BLOCKS = [(128, 1, 32), (64, 32, 64), (32, 64, 128), (16, 128, 192), (8, 192, 192), (4, 192, 192),
                (2, 192, 192), (4, 384, 192), (8, 384, 192), (16, 384, 192), (32, 320, 128), (64, 192, 64),
                (128, 96, 32)]
_UNET_BLOCKS = [(128, 1, 32), (64, 32, 64), (32, 64, 128), (16, 128, 192), (32, 320, 128), (64, 192, 64),
                (128, 96, 32)]
F32_STAGES = sorted({(batch, size, cin, co) for batch in (1, 12, 16) for size, ci, co in _PROB_BLOCKS
                     for cin in (ci, co)} | {(12, size, cin, co) for size, ci, co in _UNET_BLOCKS for cin in (ci, co)})


# ---------------------------------------------------------------------------
# (a) the tf32 split
# ---------------------------------------------------------------------------

def _values(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(len(kind))
    v = rng.standard_normal(4096)
    if kind == "ties":  # the low 13 bits exactly half a tf32 ulp: rounds away from zero
        bits = (v.astype(np.float32).view(np.int32) & ~0x1FFF) | 0x1000
        return torch.from_numpy(bits.view(np.float32))
    scale = {"random": 1.0, "tiny": 1e-30, "large": 1e30, "wide": 10.0 ** rng.uniform(-20, 20, v.shape)}[kind]
    return torch.from_numpy((v * scale).astype(np.float32))


def _tf32_round_nearest(w: np.ndarray) -> np.ndarray:
    """float64 oracle of round-to-nearest (ties away) to 11 significant bits."""
    m, e = np.frexp(w.astype(np.float64))  # w = m * 2^e, 0.5 <= |m| < 1
    return np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11.0)


@pytest.mark.parametrize("kind", ["random", "tiny", "large", "wide", "ties"])
def test_split_tf32(kind):
    """hi keeps 10 stored mantissa bits (the low 13 zero), rounded to nearest
    with ties away from zero as cvt.rna.tf32.f32 rounds; lo is the rest,
    rounded the same way; hi + lo gives w back within 2^-22 |w|."""
    w = _values(kind)
    hi, lo = conv_chain.split_tf32(w)
    assert hi.dtype == lo.dtype == torch.float32
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), _tf32_round_nearest(w.numpy()))
    np.testing.assert_array_equal(lo.numpy(), _tf32_round_nearest((w - hi).numpy()))
    assert ((hi + lo - w).abs() <= 2.0 ** -22 * w.abs()).all()
    if kind == "ties":
        assert (hi.abs() > w.abs()).all()


def test_split_tf32_keeps_zero_and_sign():
    w = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -120, -2.5])  # each a tf32 value
    hi, lo = conv_chain.split_tf32(w)
    assert torch.equal(hi, w) and not lo.any()
    assert torch.equal(torch.signbit(hi), torch.signbit(w))


# ---------------------------------------------------------------------------
# (b) the kernel's arithmetic in plain PyTorch against the JAX Pallas chain
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("shape,chans", SHAPES)
def test_3xtf32_chain_matches_jax_pallas_f32(shape, chans):
    """Three f32 convs a stage on the split operands (lo*hi + hi*lo + hi*hi)
    give the JAX Pallas kernel's float32 chain within F32_RTOL of its max,
    and the port's plain chain as closely."""
    x, ks, bs = _inputs(shape, chans)
    want = np.asarray(jax_chain(jnp.asarray(x), [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs]))
    tx = torch.from_numpy(x)
    tks = [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in ks]  # HWIO -> OIHW
    tbs = [torch.from_numpy(b) for b in bs]
    got = conv_chain.fused_conv_chain_3xtf32(tx, tks, tbs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= F32_RTOL * scale
    plain = conv_chain.fused_conv_chain_reference(tx, tks, tbs).numpy()
    assert np.abs(got.numpy() - plain).max() <= F32_RTOL * scale


def test_3xtf32_differs_from_one_tf32_product():
    """The lo terms matter: hi*hi alone (one TF32 product, what cuDNN's
    TF32 mode computes) lands ~1e-3 of max off, the three products ~1e-6."""
    x, ks, bs = _inputs(*SHAPES[0], seed=3)
    tx = torch.from_numpy(x)
    tks = [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in ks]
    tbs = [torch.from_numpy(b) for b in bs]
    plain = conv_chain.fused_conv_chain_reference(tx, tks, tbs)
    one = conv_chain.fused_conv_chain_reference(conv_chain.split_tf32(tx)[0],
                                                [conv_chain.split_tf32(k)[0] for k in tks], tbs)
    three = conv_chain.fused_conv_chain_3xtf32(tx, tks, tbs)
    scale = plain.abs().max()
    assert (one - plain).abs().max() > 1e-4 * scale
    assert (three - plain).abs().max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# (c) the launch plan the kernel checks, at every stage of the f32 main path
# ---------------------------------------------------------------------------

def _assert_f32_plan_fits_the_card(p, shape, co, aligned=True):
    batch, height, width, ci = shape
    assert p.smem_bytes <= conv_chain.SMEM_LIMIT
    assert all(0 < d <= conv_chain.TMA_BOX_MAX for d in p.halo_box + p.weight_box)
    # TMA takes global strides in multiples of 16 bytes and a 16-byte
    # aligned address: the plain loader exactly where f32 pixels miss that
    assert p.loader == ("tma" if ci % 4 == 0 and aligned else "plain")
    assert 9 * p.ci_pad * 4 % 16 == 0  # the packed weights' row, always by TMA
    assert p.chunk in conv_chain.F32_CHUNKS and p.ci_pad % p.chunk == 0
    assert p.ci_pad == conv_chain.f32_padded_ci(ci) and p.ci_pad - ci < conv_chain.f32_chunk_width(ci)
    assert p.block_n in conv_chain.F32_BLOCK_NS and p.co_pad >= co
    assert p.chunk <= 16 or p.block_n < 128  # two accumulators and two taps of split A: see the plan
    assert p.warpgroups in (1, 2) and p.threads == 128 * p.warpgroups + 32
    assert p.n_img * p.tile_h * p.tile_w <= 64 * p.warpgroups  # a tile fits its warpgroups' 64-row wgmmas
    assert p.tile_w <= min(width, conv_chain.TILE_W) and p.tile_h <= height and p.n_img <= batch
    assert p.items == (-(-batch // p.n_img) * -(-height // p.tile_h) * -(-width // p.tile_w)
                       * -(-co // p.block_n))
    assert 2 <= p.halo_stages <= 4
    chunks = p.ci_pad // p.chunk
    halo = -(-p.n_img * (p.tile_h + 2) * (p.tile_w + 2) * p.chunk * 4 // 1024) * 1024
    assert p.smem_bytes == 2048 + p.halo_stages * halo + p.weight_stages * 2 * p.block_n * p.chunk * 4
    if p.resident:
        assert p.weight_stages == 9 * chunks and p.block_n >= co
    else:
        assert 2 <= p.weight_stages <= min(54, max(8, 9 * chunks))
    if height * width < 64 and batch > 1:  # small images fold: whole images, several a tile
        assert (p.tile_h, p.tile_w) == (height, width)
        assert p.n_img == min(batch, 64 * p.warpgroups // (height * width)) > 1
    elif p.n_img > 1:
        assert p.tile_h == height


@pytest.mark.parametrize("batch,size,ci,co", F32_STAGES)
def test_f32_launch_plan_of_the_main_path(batch, size, ci, co):
    shape = (batch, size, size, ci)
    p = conv_chain.f32_launch_plan(shape, co)
    _assert_f32_plan_fits_the_card(p, shape, co)
    least = min(-(-co // n) * n for n in conv_chain.F32_BLOCK_NS)  # C_out padded to whole blocks
    widest = max(n for n in conv_chain.F32_BLOCK_NS if -(-co // n) * n == least)
    if p.items >= conv_chain.SM_COUNT:
        # the widest tile and channel block that still give every SM an item
        assert p.block_n == widest or p.warpgroups == 1
    else:
        # too few items for the card: one warpgroup a tile, 32 channels a
        # block, and (a block an SM) a weight ring as deep as memory allows
        assert (p.warpgroups, p.block_n) == (1, 32)
        assert p.resident or p.weight_stages > 8 or p.weight_stages == 9 * p.ci_pad // p.chunk


@pytest.mark.parametrize("shape,co", [((2, 16, 16, 64), 64), ((12, 2, 2, 192), 192), ((3, 4, 4, 9), 64)])
def test_f32_launch_plan_takes_the_plain_loader_for_a_misaligned_input(shape, co):
    _assert_f32_plan_fits_the_card(conv_chain.f32_launch_plan(shape, co, aligned=False), shape, co, aligned=False)
    assert conv_chain.f32_launch_plan(shape, co, aligned=False).loader == "plain"


@pytest.mark.parametrize("choice", [{"warpgroups": 1}, {"warpgroups": 2}, {"block_n": 32}, {"block_n": 64},
                                    {"resident": False}])
@pytest.mark.parametrize("shape,co", [((12, 128, 128, 32), 32), ((12, 8, 8, 384), 192), ((1, 2, 2, 192), 192)])
def test_f32_launch_plan_takes_other_choices(choice, shape, co):
    """The plans that tools/torch_conv_chain_stages.py --dtype float32
    --plans times keep the choice they were given and fit the card."""
    p = conv_chain.f32_launch_plan(shape, co, **choice)
    _assert_f32_plan_fits_the_card(p, shape, co)
    assert all(getattr(p, key) == value for key, value in choice.items())


def test_f32_packed_layout_matches_the_plan():
    """fused_conv_chain checks packed buffers against packed_shape, whose
    C_in padding is the plan's."""
    for ci in (1, 4, 9, 32, 37, 96, 192, 320, 384):
        k = torch.zeros((40, ci, 3, 3))
        packed = conv_chain.pack_kernel(k, torch.float32)
        assert tuple(packed.shape) == conv_chain.packed_shape(40, ci, torch.float32) == (2, 64, 3, 3, packed.shape[-1])
        assert packed.shape[-1] == conv_chain.f32_launch_plan((2, 8, 8, ci), 40).ci_pad


# ---------------------------------------------------------------------------
# Trainer's float32 precision
# ---------------------------------------------------------------------------

TINY = dict(experiment_name="tiny_unet", model="unet", filter_channels=(4, 8, 8, 8), n_classes=2,
            image_size=(32, 32), seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tf32", [None, True])
def test_trainer_sets_and_logs_tf32(dtype, tf32, tmp_path, monkeypatch, caplog):
    """Trainer turns cuDNN's and float32 matmuls' TF32 off unless asked
    (PyTorch lets cuDNN take TF32 by default) and logs the choice beside the
    conv chain's route; the flags are the process's, so they are restored."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32 is None)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32 is None)
    kwargs = {} if tf32 is None else {"tf32": tf32}
    with caplog.at_level(logging.INFO, logger="unet_zoo_tpu_torch.training.trainer"):
        trainer = Trainer(ExperimentConfig(**TINY, dtype=dtype), device="cpu", log_dir=str(tmp_path),
                          tensorboard=False, **kwargs)
    on = bool(tf32)
    assert torch.backends.cudnn.allow_tf32 is on and torch.backends.cuda.matmul.allow_tf32 is on
    assert trainer.tf32 is on
    line = next(r.getMessage() for r in caplog.records if "BN-free conv chains run on" in r.getMessage())
    assert f"run on: {trainer.chain_route}; TF32 in cuDNN convolutions and float32 matmuls: {'on' if on else 'off'}" \
        in line
    trainer.close()
