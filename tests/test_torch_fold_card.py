"""Eval-mode BatchNorm folded into the float32 conv-chain kernel, on the card.

``ops.conv.ConvSeq`` folds an eval-mode BatchNorm sequence into the kernel
(``ConvSeq.folds``): one ``fold_bn_pack_f32`` launch, then a
``conv3x3_f32_3xtf32_wgmma`` launch a stage, each tap's sum rounded into the
total (``round_taps``). Here, on a CUDA card: the fold launch against its
plain version (bit for bit), ``round_taps`` against a float64 conv beside
the kernel's chunk sums, every BatchNorm sequence of a ``phiseg_7_5_12``
evaluation at its batch on the folded route against the library route
(cuDNN, TF32 off), and one ``Trainer.eval_image`` on each route. Each test
is marked ``card`` and skips where there is no card.

The file imports torch and the port only, so that it runs on the card's
machine, which has no JAX, without the suite's ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fold_card.py

(as every ``tests/test_torch_*_card.py`` runs on the card).
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops import conv as conv_ops
from unet_zoo_tpu_torch.ops.pallas import conv_chain

# every BatchNorm sequence of a phiseg_7_5_12 evaluation, as (batch, size, C_in, C_out of each stage): the
# sample runs the prior's trunk at batch 1 and the latent path and the likelihood on its 100 samples folded into
# the batch; the eval-mode loss runs the posterior, the prior and the likelihood at batch 1
_SAMPLED = [(2, 2, (192, 192)), (2, 192, (192, 192)), (4, 2, (64, 64)), (4, 2, (192, 192)), (4, 192, (192,)),
            (4, 256, (256, 256)), (8, 2, (64, 64)), (8, 2, (128, 128)), (8, 192, (192,)), (8, 256, (256, 256)),
            (16, 2, (64, 64)), (16, 128, (128,)), (16, 192, (192,)), (16, 256, (256, 256)), (16, 384, (192, 192)),
            (32, 2, (32, 32)), (32, 2, (64, 64)), (32, 64, (64,)), (32, 128, (128,)), (32, 192, (192, 192)),
            (32, 320, (192, 192)), (64, 32, (32,)), (64, 64, (64,)), (64, 256, (192, 192)), (128, 32, (32,)),
            (128, 224, (128, 128))]
_TRUNK = [(2, 192, (192,) * 3), (4, 192, (192,) * 3), (8, 192, (192,) * 3), (16, 128, (192,) * 3),
          (32, 64, (128,) * 3), (64, 32, (64,) * 3), (128, 1, (32,) * 3)]
EVAL_SAMPLES = 100
EVAL_SEQUENCES = ([(EVAL_SAMPLES, *s) for s in _SAMPLED] + [(1, *s) for s in _SAMPLED + _TRUNK]
                  + [(1, 128, 3, (32,) * 3)])  # the posterior's first sequence: the image and the mask
# per image: the sample's 67 stages in 35 sequences and the eval-mode loss's 106 in 51
EVAL_STAGES, EVAL_FOLDS = 67 + 106, 35 + 51
# max|folded - library| <= F32_RTOL * max|library|: the f32 chain's gate (tests/test_torch_conv_chain_f32.py)
F32_RTOL = 1e-4
# an evaluated image on the two routes: the benchmark's limits of the evaluation against its reference
# (benchmark/workloads/phiseg_lidc.eval100.json): GED and NCC absolute, the loss terms relative
GED_ATOL, NCC_ATOL, LOSS_RTOL = 2e-4, 4e-5, 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow


def eval_norm_sequence(ci: int, co: int, depth: int, seed: int, dtype=None, ndim: int = 2) -> conv_ops.ConvSeq:
    """An eval-mode ``ConvSeq(norm=True)`` on the CPU with non-trivial
    running statistics and BatchNorm parameters."""
    gen = torch.Generator().manual_seed(seed)
    seq = conv_ops.ConvSeq(ci, co, depth, norm=True, init_scheme="torch_default", dtype=dtype, generator=gen,
                           ndim=ndim)
    with torch.no_grad():
        for layer in seq.children():
            bn = layer.bn
            bn.running_mean.normal_(0.0, 0.5, generator=gen)
            bn.running_var.uniform_(0.25, 4.0, generator=gen)
            bn.weight.normal_(1.0, 0.3, generator=gen)
            bn.bias.normal_(0.0, 0.3, generator=gen)
    return seq.eval()


def _stages(seq: conv_ops.ConvSeq) -> list:
    return [(m.conv.weight, m.conv.bias, m.bn.weight, m.bn.bias, m.bn.running_mean, m.bn.running_var, m.bn.eps)
            for m in seq.children()]


def _buffers(seq: conv_ops.ConvSeq, device) -> tuple:
    shapes = [m.conv.weight.shape[:2] for m in seq.children()]
    packed = [torch.zeros(conv_chain.packed_shape(co, ci, torch.float32), device=device) for co, ci in shapes]
    return packed, [torch.zeros(co, device=device) for co, _ in shapes]


@pytest.mark.card
@pytest.mark.parametrize("ci,cos", sorted({(ci, cos) for _, _, ci, cos in EVAL_SEQUENCES}))
def test_fold_bn_pack_kernel_equals_its_plain_version(card, ci, cos):
    """One launch folds and packs the sequence's stages; the packed halves
    and the folded biases equal the plain version's, on the card and on the
    CPU, bit for bit, padding zero included."""
    seq = eval_norm_sequence(ci, cos[0], len(cos), seed=ci * 1000 + len(cos)).to(card)
    packed, biases = _buffers(seq, card)
    # the kernel writes every element: garbage in the buffers must not survive
    for t in packed + biases:
        t.fill_(float("nan"))
    before = conv_chain.fold_launches
    conv_chain.fold_bn_pack(_stages(seq), packed, biases)
    torch.cuda.synchronize()
    assert conv_chain.fold_launches == before + 1
    plain_packed, plain_biases = _buffers(seq, card)
    conv_chain.fold_bn_pack_reference(_stages(seq), plain_packed, plain_biases)
    cpu = seq.to("cpu")
    cpu_packed, cpu_biases = _buffers(cpu, "cpu")
    conv_chain.fold_bn_pack(_stages(cpu), cpu_packed, cpu_biases)
    for got, card_plain, cpu_plain in zip(packed + biases, plain_packed + plain_biases, cpu_packed + cpu_biases):
        assert torch.equal(got.view(torch.int32), card_plain.view(torch.int32))
        assert torch.equal(got.cpu().view(torch.int32), cpu_plain.view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("batch,size,ci,co", [(100, 32, 320, 192), (100, 128, 224, 128), (1, 16, 384, 192)])
def test_round_taps_lands_closer_to_float64(card, batch, size, ci, co):
    """A ``round_taps`` launch is within F32_RTOL of a float64 conv, and its
    mean error there, where the tensor cores' truncation shows as a bias,
    is under a third of the chunk sums' (a post-ReLU input: a mean to
    truncate)."""
    gen = torch.Generator(card).manual_seed(size + ci)
    x = torch.relu(torch.randn((batch, size, size, ci), generator=gen, device=card))
    k = torch.randn((co, ci, 3, 3), generator=gen, device=card) / (3 * ci ** 0.5)
    b = torch.zeros(co, device=card)
    with torch.inference_mode():
        chunks = conv_chain.fused_conv_chain(x, [k], [b])
        taps = conv_chain.fused_conv_chain(x, [k], [b], round_taps=True)
        exact = torch.relu(F.conv2d(x.double().permute(0, 3, 1, 2), k.double(), padding=1).permute(0, 2, 3, 1))
    on = exact > 0
    scale = exact[on].mean().item()
    bias = {name: abs((y.double() - exact)[on].mean().item()) / scale for name, y in (("chunks", chunks), ("taps", taps))}
    assert (taps.double() - exact).abs().max().item() <= F32_RTOL * exact.abs().max().item()
    assert bias["taps"] * 3 <= bias["chunks"], bias


@pytest.mark.card
@pytest.mark.parametrize("batch,size,ci,cos", EVAL_SEQUENCES)
def test_folded_sequence_matches_the_library_route(card, batch, size, ci, cos):
    """An eval-mode BatchNorm sequence at a PHiSeg evaluation shape runs
    folded (one fold launch, a kernel launch a stage) and gives the library
    route's conv -> BatchNorm -> ReLU within F32_RTOL of its max."""
    seq = eval_norm_sequence(ci, cos[0], len(cos), seed=size * 1000 + ci + batch).to(card)
    x = torch.randn((batch, size, size, ci), generator=torch.Generator(card).manual_seed(batch + size), device=card)
    with torch.inference_mode():
        assert seq.folds(x)
        launches, folds = conv_chain.launches, conv_chain.fold_launches
        got = seq(x)
        torch.cuda.synchronize()
        assert (conv_chain.launches - launches, conv_chain.fold_launches - folds) == (len(cos), 1)
        want = x
        for layer in seq.children():  # the library route, layer by layer
            want = layer(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = want.abs().max().item()
    assert scale > 0 and (got - want).abs().max().item() <= F32_RTOL * scale


@contextlib.contextmanager
def _library_route():
    orig = conv_ops.ConvSeq.folds
    conv_ops.ConvSeq.folds = lambda self, x: False
    try:
        yield
    finally:
        conv_ops.ConvSeq.folds = orig


@pytest.mark.card
def test_eval_image_agrees_with_the_library_route(card, tmp_path):
    """One phiseg_7_5_12 image, 100 samples: the folded route launches the
    kernel EVAL_STAGES times and the fold EVAL_FOLDS times, and its GED, NCC
    and loss terms agree with the library route's on the same weights,
    running statistics and z noise."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment("phiseg_7_5_12")
    trainer = Trainer(cfg, card, seed=3, log_dir=str(tmp_path))
    model = trainer.state.model
    gen = torch.Generator(card).manual_seed(4)
    x = torch.randn((4, *cfg.image_size, 1), generator=gen, device=card)
    y_all = (torch.randn((4, *cfg.image_size), generator=gen, device=card) > 0.3).long()
    # running statistics of one train-mode pass, as a trained model holds them
    bns = [m for m in model.modules() if isinstance(m, conv_ops.BatchNorm)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        model(x, y_all)
    for bn, m in zip(bns, momenta):
        bn.momentum = m
    outs = {}
    for route in ("folded", "library"):
        with _library_route() if route == "library" else contextlib.nullcontext():
            launches, folds = conv_chain.launches, conv_chain.fold_launches
            out = trainer.eval_image(x[:1], y_all, y_all[:1], EVAL_SAMPLES, salt=1, index=2)
            torch.cuda.synchronize()
            outs[route] = ({k: v.item() for k, v in out.items() if v.numel() == 1},
                           (conv_chain.launches - launches, conv_chain.fold_launches - folds))
    (folded, counts), (library, library_counts) = outs["folded"], outs["library"]
    assert counts == (EVAL_STAGES, EVAL_FOLDS) and library_counts == (0, 0)
    assert abs(folded["ged"] - library["ged"]) <= GED_ATOL
    assert abs(folded["ncc"] - library["ncc"]) <= NCC_ATOL
    for k in ("loss", "kl", "recon"):
        assert abs(folded[k] - library[k]) <= LOSS_RTOL * abs(library[k]), k
