"""Spatial sharding (``unet_zoo_tpu_torch.parallel.space``, the mesh's space
axis) on one card: two processes sharing it over gloo
(``tests/torch_space_card_worker.py``), one data group split in height,
each within SPACE_MEMORY_FRACTION of the card, started together with a time
limit, against one process. The halo tiles against the unsplit kernel are
in ``tests/test_torch_kernel_card.py``; ``tools/torch_space_nccl.py`` runs
the same processes over NCCL on four cards.

* (a) the bf16 ``unet`` step at bs64: 21 launches a step on each process,
  the first step's loss and gradient against one process's;
* (b) the registered ``phiseg_uzh_7_5_512`` step (f32, TF32 off, bs12)
  against one process's at PHiSeg's train-mode gates, each process's peak
  below one process's alone and within the same share, one forward's graph
  at most SPACE_GRAPH_SHARE of one process's;
* (c) the ``dryrun_multichip`` twin: finite losses.

The processes hold one state after every step.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_space_card.py
"""

import pytest
import torch

import torch_space_card_worker as worker
from torch_card import SPACE_MEMORY_FRACTION
from torch_card_checks import card  # noqa: F401  (the fixture)

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def ranks(card, tmp_path_factory):
    """What the two processes wrote, and their directory."""
    workdir = str(tmp_path_factory.mktemp("space"))
    torch.cuda.empty_cache()
    return worker.spawn(workdir), workdir


def test_unet_against_one_process(card, ranks):
    worker.unet_checks(card, *ranks)


def test_uzh_against_one_process_and_memory(card, ranks):
    worker.uzh_checks(card, *ranks, SPACE_MEMORY_FRACTION)


def test_dryrun_twin(ranks):
    worker.dryrun_checks(ranks[0])
