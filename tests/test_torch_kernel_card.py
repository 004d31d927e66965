"""The conv-chain kernels on the card: their build and machine code, each
instantiation against its plain version, and repeated launches bit for bit.

* ptxas serialized no ``wgmma`` (C7512, C7513, C7518: after a divergent
  role branch, or with A registers redefined across a runtime loop) and
  spilled nothing in the float32 kernel;
* the machine code (``cuobjdump -sass``, else ptxas's log): every bf16 and
  f32 instantiation issues ``HGMMA`` and TMA loads (``UTMALDG``) and no
  ``mma.sync`` (``HMMA``), and no other kernel is there but
  ``fold_bn_pack_f32``;
* the kernel against its plain version at the kernel tests' shapes, the
  edge shapes, a zero border and each U-Net block at batch 8, in float32 and
  bfloat16 (float32 also against its own 3xTF32 arithmetic in plain
  PyTorch), and at ProbUNet's 13 trunk blocks at batches 1, 12 and 16;
* REPEATS launches of each U-Net block (bs512, bs64, the model's weights)
  and of each float32 ProbUNet block at bs12 bit for bit against the
  first: a race between the pipeline's producer and its consumers shows
  only as launches that disagree;
* the halo tiles of spatial sharding: each block run stage by stage on two
  tiles of h + 2 rows and stitched, against the unsplit kernel and the
  plain version.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_card.py
"""

import os
import re
import shutil
import subprocess

import pytest
import torch
import torch.nn.functional as F

from torch_card import (BATCH, BF16_ULPS, BLOCKS, EDGE_SHAPES, F32_EDGE_SHAPES, FILTERS, PROB_BATCH, PROB_BLOCKS,
                        PROB_CHECK_BATCHES, TEST_SHAPES, TRAIN_BATCH, bf16_ulp, block_chans, chain_weights)
from torch_card_checks import compare, repeats_differ
from torch_card_checks import card  # noqa: F401  (the fixture)
from unet_zoo_tpu_torch.ops.pallas import _build, conv_chain

pytestmark = pytest.mark.card

# the machine code every kernel instantiation must hold, and must not
SASS_REQUIRED = ("HGMMA", "UTMALDG")
SASS_FORBIDDEN = ("HMMA",)
BF16_INSTANTIATIONS = 12  # conv3x3_bf16_wgmma<N, K chunk>: N 32/64/128/192 x chunk 16/32/64
# conv3x3_f32_3xtf32_wgmma<N, K chunk, round taps>: N 32/64 x chunk 8/16/32, N 96 x 8/16 with each K chunk's sum
# rounded into the total, and N 32/64/96 x chunk 8 with each tap's (the folded BatchNorm sequences' launches)
F32_INSTANTIATIONS = 11
FOLD_KERNEL = "fold_bn_pack_f32"
F32_ROUTE = "conv3x3_f32_3xtf32_wgmma"
SPACE_TILES = 2  # the halo tiles of a space-2 mesh

# (kind, x shape, [(C_in, C_out) a stage]) of each dtype's kernel-against-plain case
_CASES = {dtype: [("test", s, c) for s, c in TEST_SHAPES]
          + [("edge", s, c) for s, c in EDGE_SHAPES + (F32_EDGE_SHAPES if dtype == "float32" else [])]
          + [("zero-border", (1, 12, 12, 3), [(3, 4), (4, 4)])]
          + [(block, (8, size, size, ci), block_chans(ci, co)) for block, size, ci, co in BLOCKS]
          for dtype in ("float32", "bfloat16")}
CASES = [(dtype, i, *case) for dtype, cases in _CASES.items() for i, case in enumerate(cases)]


def kernel_name(mangled: str) -> str:
    """conv3x3_bf16_wgmma<BN, KC>, conv3x3_f32_3xtf32_wgmma<BN, KC, ROUND_TAPS>
    or fold_bn_pack_f32 from a mangled name."""
    m = re.search(r"(conv3x3_bf16_wgmma|conv3x3_f32_3xtf32_wgmma)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?", mangled)
    if m:
        taps = "" if m.group(4) is None else ("," + ("true" if m.group(4) == "1" else "false"))
        return f"{m.group(1)}<{m.group(2)},{m.group(3)}{taps}>"
    return FOLD_KERNEL if FOLD_KERNEL in mangled else mangled


@pytest.fixture(scope="module")
def build_log(card):
    _build.load()
    return _build.library_path().with_suffix(".log").read_text()


def test_ptxas_serializes_no_wgmma_and_spills_nothing_in_f32(build_log):
    name, faults = None, []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill stores" in line:
            if (name or "").startswith("conv3x3_f32") and any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                faults.append(f"ptxas spills in {name}: {line.strip()}")
        if re.search(r"C751[238]", line) or "serialized" in line:
            faults.append(f"ptxas serialized the wgmma: {line.strip()}")
    assert not faults, "; ".join(faults)


def test_machine_code_issues_wgmma_and_tma_loads(build_log):
    """Read from the machine code where the toolkit has cuobjdump, else from
    ptxas's log (each entry compiled for sm_90a, which alone has wgmma)."""
    from torch.utils.cpp_extension import CUDA_HOME

    want = {"conv3x3_bf16_wgmma": BF16_INSTANTIATIONS, "conv3x3_f32_3xtf32_wgmma": F32_INSTANTIATIONS}
    tools = (shutil.which("cuobjdump"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "cuobjdump"))
    tool = next((t for t in tools if t and os.access(t, os.X_OK)), None)
    if tool is None:
        entries = [kernel_name(m) for m in re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'", build_log)]
        for family, n in want.items():
            got = [e for e in entries if e.startswith(family + "<")]
            assert len(got) == n, f"ptxas compiled {len(got)} {family} kernels for sm_90a, expected {n}"
        assert len(entries) == sum(want.values()) + 1 and FOLD_KERNEL in entries, \
            f"ptxas compiled other kernels too: {entries}"
        return
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = {op: 0 for op in SASS_REQUIRED + SASS_FORBIDDEN}
        elif name:
            for op in counts[name]:
                counts[name][op] += len(re.findall(rf"\b{op}\b", line))
    for family, n in want.items():
        got = [k for k in counts if k.startswith(family + "<")]
        assert len(got) == n, f"{len(got)} {family} kernels in the library's machine code, expected {n}"
    assert len(counts) == sum(want.values()) + 1 and FOLD_KERNEL in counts and "conv3x3_f32_fma" not in sass, \
        f"other kernels in the library's machine code: {sorted(counts)}"
    for k, v in counts.items():
        required = () if k == FOLD_KERNEL else SASS_REQUIRED
        assert all(v[op] > 0 for op in required) and not any(v[op] for op in SASS_FORBIDDEN), \
            f"{k}: machine code {v}, needs {required} and none of {SASS_FORBIDDEN}"


def test_f32_chains_route_to_the_kernel(card):
    from unet_zoo_tpu_torch.ops.conv import chain_route

    assert chain_route(torch.float32, card) == F32_ROUTE


@pytest.mark.parametrize("dtype,seed,kind,shape,chans", CASES, ids=[f"{d}-{k}-{s}" for d, _, k, s, _ in CASES])
def test_kernel_matches_its_plain_version(card, dtype, seed, kind, shape, chans):
    dtype = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    if kind == "zero-border":
        x = torch.ones(shape, device=card, dtype=dtype)
        ks = [torch.full((co, ci, 3, 3), 0.1, device=card) for ci, co in chans]
        bs = [torch.zeros(co, device=card) for _, co in chans]
    else:
        x = torch.randn(shape, generator=gen).to(card, dtype)
        ks, bs = chain_weights(chans, gen, card, scale=0.2 if kind == "test" else None)
    compare(x, ks, bs, f"{dtype} {kind} {shape} {chans}")


@pytest.fixture(scope="module")
def unet_bf16(card):
    from unet_zoo_tpu_torch.models.registry import get_model

    return get_model("unet", num_classes=2, num_filters=FILTERS, dtype=torch.bfloat16, device=card,
                     generator=torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("batch", [BATCH, TRAIN_BATCH])
@pytest.mark.parametrize("block,size,ci,co", BLOCKS)
def test_unet_block_repeats_bit_for_bit(card, unet_bf16, block, size, ci, co, batch):
    """A U-Net block on the model's weights: the kernel against its plain
    version, then REPEATS launches bit for bit against the first."""
    convs = [m.conv for m in getattr(unet_bf16, block).convs.children()]
    ks, bs = [c.weight for c in convs], [c.bias for c in convs]
    gen = torch.Generator(device=card).manual_seed(1)
    with torch.inference_mode():
        x = torch.randn((batch, size, size, ci), generator=gen, device=card).to(torch.bfloat16)
        compare(x, ks, bs, f"bf16 {block} bs{batch}")
        differ = repeats_differ(x, ks, bs)
    assert differ == 0, f"{block} bs{batch}: {differ} repeated launches differ from the first"


@pytest.mark.parametrize("block,size,ci,co", PROB_BLOCKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prob_unet_block(card, dtype, block, size, ci, co):
    """A ProbUNet trunk block at each batch its path gives the kernel (the
    launch plan's tiles and items depend on the batch), kernel against plain;
    in float32 at bs12 also REPEATS launches bit for bit."""
    gen = torch.Generator().manual_seed(14)
    ks, bs = chain_weights(block_chans(ci, co), gen, card)
    with torch.inference_mode():
        for batch in PROB_CHECK_BATCHES:
            x = torch.randn((batch, size, size, ci), generator=gen).to(card, getattr(torch, dtype))
            compare(x, ks, bs, f"{dtype} prob_unet {block} bs{batch}")
            if dtype == "float32" and batch == PROB_BATCH:
                differ = repeats_differ(x, ks, bs)
                assert differ == 0, f"f32 {block} bs{batch}: {differ} repeated launches differ"


@pytest.mark.parametrize("block,size,ci,co", BLOCKS)
def test_halo_tiles_match_the_unsplit_kernel(card, block, size, ci, co):
    """A BN-free block at bs64 in bf16 as the space path runs it on two
    processes: stage by stage on tiles of h + 2 rows of the zero-padded
    stage input (what a halo exchange gives), each cropped of its two edge
    rows and stitched, within BF16_ULPS of the unsplit kernel and of the
    plain version."""
    gen = torch.Generator().manual_seed(14)
    x = torch.randn((TRAIN_BATCH, size, size, ci), generator=gen).to(card, torch.bfloat16)
    ks, bs = chain_weights(block_chans(ci, co), gen, card)
    whole = conv_chain.fused_conv_chain(x, ks, bs)
    ref = conv_chain.fused_conv_chain_reference(x, ks, bs)
    h = size // SPACE_TILES
    y = x
    for k, b in zip(ks, bs):
        padded = F.pad(y, (0, 0, 0, 0, 1, 1))
        y = torch.cat([conv_chain.fused_conv_chain(padded[:, r * h:r * h + h + 2].contiguous(), [k], [b])[:, 1:-1]
                       for r in range(SPACE_TILES)], dim=1)
    torch.cuda.synchronize()
    diff = (y.float() - whole.float()).abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = BF16_ULPS * bf16_ulp(ref.float().abs().max().item())
    assert err <= tol and diff <= tol, f"halo tiles {block}: {err} from the plain version, {diff} from the kernel"
