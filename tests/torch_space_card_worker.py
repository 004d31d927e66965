"""The processes of a spatially sharded run on the card, and the checks of
what they wrote against one process, for ``tests/test_torch_space_card.py``
(two processes sharing one card over gloo) and ``tools/torch_space_nccl.py``
(four, one a card, over NCCL); imports torch and the port only.

    python tests/torch_space_card_worker.py RANK PORT WORKDIR [WORLD BACKEND]

One process of WORLD (default 2, gloo) on a mesh of space SPACE_RANKS, each
step on its data group's images of the global batch, within
SPACE_MEMORY_FRACTION of the card where processes share one:

* (a) the bf16 ``unet`` at bs64, 128x128, SPACE_UNET_STEPS steps;
* (b) the registered ``phiseg_uzh_7_5_512`` step (f32, TF32 off, bs12,
  512x512), its peak and one forward's graph;
* (c) the twin of ``dryrun_multichip``: ``phiseg`` at the published widths
  on a 64x64 image, two steps, then the tiny PHiSeg3D step;

each step's loss and launches, and whether the processes hold one state
after it, to ``WORKDIR/space_<RANK>.pt``; then prints ``DONE <RANK>``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_card import (MIB, PHISEG_LOSS_RTOL, PHISEG_STATS_RTOL, PHISEG_TRAIN_GRAD_L2, SPACE_GRAPH_SHARE,  # noqa: E402
                        SPACE_MEMORY_FRACTION, TRAIN_BATCH, TRAIN_GRAD_RTOL_OF_MAX, TRAIN_LOSS_RTOL, UNET_LAUNCHES,
                        flat_rel_l2, spawn_workers, train_batches)

SPACE_RANKS = 2  # the space axis: one data group's height split in two
SPACE_TIMEOUT = 600  # seconds for the processes' whole run
SPACE_UNET_STEPS = 2  # (a): the first held against one process
UZH_EXPERIMENT = "phiseg_uzh_7_5_512"
# (c): the twin of dryrun_multichip (__graft_entry__.py): PHiSeg at the
# published widths on a small image, two steps; then the tiny PHiSeg3D
DRYRUN_FILTERS = (32, 64, 128, 192, 192, 192, 192)
DRYRUN_SIZE = 64
DRYRUN_3D = dict(filter_channels=(2, 4, 4), latent_levels=2, n_classes=3, num_labels_per_subject=1,
                 input_channels=4, image_size=(16, 16, 16))


def space_batch(dev, batch: int, size: int, classes: int, seed: int):
    """A batch of (batch, size, size, 1) noise from a fixed seed, labelled
    in ``classes`` bands of a 9x9 box blur of it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, 1, size, size), generator=gen, device=dev)
    blur = torch.nn.functional.avg_pool2d(x, 9, 1, 4)
    edges = torch.linspace(-0.1, 0.1, classes - 1, device=dev) if classes > 2 else torch.zeros(1, device=dev)
    return x.view(batch, size, size, 1), torch.bucketize(blur, edges).view(batch, size, size)


def graph_mib(tr, x, y) -> float:
    """MiB that one train-mode forward and loss of ``tr`` leave allocated
    (the autograd graph's saved tensors: the step's activation memory,
    without the backward's and cuDNN's transient workspace), inside
    ``space_sharding`` as the step runs them; no backward follows."""
    from unet_zoo_tpu_torch.parallel.space import space_sharding

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with space_sharding(tr.mesh):
        xa, ya = tr.augment(x, y)
        loss, _ = tr.forward_loss(xa, ya)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del loss, xa, ya
    return held / MIB


def main(rank: int, port: int, workdir: str, world: int = SPACE_RANKS, backend: str = "gloo") -> None:
    import torch.distributed as dist

    from unet_zoo_tpu_torch.data.augment import AugmentOptions
    from unet_zoo_tpu_torch.experiments import ExperimentConfig, get_experiment
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.parallel import init_distributed, make_mesh, replicated, shard_batch
    from unet_zoo_tpu_torch.training import Trainer

    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda", backend=backend), "no process group"
    assert dist.get_backend() == backend, f"the group runs {dist.get_backend()}"
    mesh = make_mesh(space=SPACE_RANKS)
    dev = mesh.device
    assert (mesh.data, mesh.space) == (world // SPACE_RANKS, SPACE_RANKS), f"mesh {mesh}"
    if world > torch.cuda.device_count():
        torch.cuda.set_per_process_memory_fraction(SPACE_MEMORY_FRACTION, dev)
    log_dir = os.path.join(workdir, f"log{rank}")
    out = {}

    def step(tr, x, y):
        torch.cuda.synchronize()
        start = conv_chain.launches
        aux = tr.train_step(shard_batch(mesh, x), shard_batch(mesh, y))
        torch.cuda.synchronize()
        assert replicated(mesh, [*tr.state.model.parameters(), *tr.state.model.buffers()]), \
            f"process {rank}: the processes' states differ after a step"
        return {"loss": aux["loss"].item(), "launches": conv_chain.launches - start}

    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=TRAIN_BATCH)
    xs, ys = train_batches(SPACE_UNET_STEPS, dev)
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["unet"] = []
    for i in range(SPACE_UNET_STEPS):
        out["unet"].append(step(tr, xs[i], ys[i]))
        if i == 0:
            out["unet_grads"] = {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()}
    del tr
    torch.cuda.empty_cache()

    cfg = get_experiment(UZH_EXPERIMENT)
    x, y = space_batch(dev, cfg.batch_size, cfg.image_size[0], cfg.n_classes, seed=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["uzh"] = step(tr, x, y)
    out["uzh"]["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    out["uzh_grads"] = {n: p.grad.cpu() for n, p in tr.state.model.named_parameters()}
    out["uzh_state"] = {k: v.cpu() for k, v in tr.state.model.state_dict().items() if "running" in k}
    tr.state.optimizer.zero_grad(set_to_none=True)
    out["uzh"]["graph_mib"] = graph_mib(tr, shard_batch(mesh, x), shard_batch(mesh, y))
    del tr
    torch.cuda.empty_cache()

    cfg = ExperimentConfig(experiment_name="dryrun", model="phiseg", filter_channels=DRYRUN_FILTERS,
                           latent_levels=5, n_classes=2, batch_size=2, image_size=(DRYRUN_SIZE,) * 2,
                           augmentation_options=AugmentOptions(do_rotations=True, do_fliplr=True, augment_every_nth=2,
                                                               nlabels=2))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, DRYRUN_SIZE, DRYRUN_SIZE, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (2, DRYRUN_SIZE, DRYRUN_SIZE)))
    tr = Trainer(cfg, seed=0, log_dir=log_dir, mesh=mesh)
    out["dryrun"] = [step(tr, x.to(dev), y.to(dev)) for _ in range(2)]
    cfg3d = ExperimentConfig(experiment_name="dryrun3d", model="phiseg3d", data_loader="brats", batch_size=2,
                             **DRYRUN_3D)
    x3 = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 4)).astype(np.float32))
    y3 = torch.from_numpy((rng.random((2, 16, 16, 16, 3)) > 0.5).astype(np.float32))
    tr = Trainer(cfg3d, seed=0, log_dir=log_dir, mesh=mesh)
    out["dryrun3d"] = step(tr, x3.to(dev), y3.to(dev))
    torch.save(out, os.path.join(workdir, f"space_{rank}.pt"))
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


def spawn(workdir: str, world: int = SPACE_RANKS, backend: str = "gloo", timeout: float = SPACE_TIMEOUT) -> list:
    """Runs ``world`` processes (``main``) together within ``timeout``
    seconds (``torch_card.spawn_workers``); returns what each wrote."""
    spawn_workers(__file__, workdir, world, (world, backend), timeout)
    return [torch.load(os.path.join(workdir, f"space_{r}.pt"), weights_only=False) for r in range(world)]


def unet_checks(dev, ranks: list, workdir: str) -> None:
    """(a): 21 launches a step on each process, the processes' losses equal,
    and the first step's loss and gradient against one process's step from
    the same state and draws at the kernel-against-plain train gates."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.ops.pallas import conv_chain
    from unet_zoo_tpu_torch.training import Trainer

    launches = [[s["launches"] for s in r["unet"]] for r in ranks]
    assert all(n == UNET_LAUNCHES for row in launches for n in row), f"space unet launches a process {launches}"
    assert all(r["unet"][i]["loss"] == ranks[0]["unet"][i]["loss"] for r in ranks for i in range(SPACE_UNET_STEPS)), \
        "the processes' losses differ"
    cfg = dataclasses.replace(get_experiment("unet"), dtype="bfloat16", batch_size=TRAIN_BATCH)
    xs, ys = train_batches(1, dev)
    one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
    torch.cuda.synchronize()
    start = conv_chain.launches
    loss = one.train_step(xs[0], ys[0])["loss"].item()
    torch.cuda.synchronize()
    assert conv_chain.launches - start == UNET_LAUNCHES, f"one-process unet step launched {conv_chain.launches - start}"
    grads = {n: p.grad for n, p in one.state.model.named_parameters()}
    got = ranks[0]["unet_grads"]
    loss_rel = abs(ranks[0]["unet"][0]["loss"] - loss) / abs(loss)
    worst = max(((got[n].float().cpu() - v.float().cpu()).abs().max() / v.float().abs().max().clamp_min(1e-30)).item()
                for n, v in grads.items())
    assert loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL_OF_MAX, \
        f"space unet: loss rel {loss_rel}, gradient worst {worst}"


def uzh_checks(dev, ranks: list, workdir: str, share=None) -> None:
    """(b): the registered UZH step against one process alone on a card
    from the same state and draws, at PHiSeg's train-mode gates; each
    process's peak below one process's (and, with ``share``, each process's
    share of the card, below one process's within that share: cuDNN's
    workspace fills what a share leaves), and one forward's graph at most
    SPACE_GRAPH_SHARE of one process's."""
    from unet_zoo_tpu_torch.experiments import get_experiment
    from unet_zoo_tpu_torch.training import Trainer

    cfg = get_experiment(UZH_EXPERIMENT)
    x, y = space_batch(dev, cfg.batch_size, cfg.image_size[0], cfg.n_classes, seed=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
    loss = one.train_step(x, y)["loss"].item()
    torch.cuda.synchronize()
    one_peak = (torch.cuda.max_memory_allocated(dev) - base) / MIB
    grads = {n: p.grad.clone() for n, p in one.state.model.named_parameters()}
    want_stats = {k: v.clone() for k, v in one.state.model.state_dict().items() if "running" in k}
    one.state.optimizer.zero_grad(set_to_none=True)
    one_graph = graph_mib(one, x, y)
    got = ranks[0]
    loss_rel = abs(got["uzh"]["loss"] - loss) / abs(loss)
    l2 = flat_rel_l2(got["uzh_grads"], grads)
    stats = max(((got["uzh_state"][k].to(dev) - v).abs().max() / v.abs().max()).item() for k, v in want_stats.items())
    assert loss_rel <= PHISEG_LOSS_RTOL and l2 <= PHISEG_TRAIN_GRAD_L2 and stats <= PHISEG_STATS_RTOL, \
        f"space uzh: loss rel {loss_rel}, gradient rel L2 {l2}, statistics {stats}"
    del one, grads
    torch.cuda.empty_cache()
    peaks, graphs = [r["uzh"]["peak_mib"] for r in ranks], [r["uzh"]["graph_mib"] for r in ranks]
    assert max(peaks) < one_peak, f"space uzh: a process peaked {max(peaks):.1f} MiB, one process {one_peak:.1f}"
    if share is not None:
        torch.cuda.set_per_process_memory_fraction(share, dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        one_shared = None
        try:
            one = Trainer(cfg, dev, seed=0, log_dir=os.path.join(workdir, "one"))
            one.train_step(x, y)
            torch.cuda.synchronize()
            one_shared = (torch.cuda.max_memory_allocated(dev) - base) / MIB
        except torch.OutOfMemoryError:
            pass
        finally:
            one = None
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        assert one_shared is None or max(peaks) < one_shared, \
            f"space uzh: a process peaked {max(peaks):.1f} MiB, one process within the same share {one_shared:.1f}"
    assert max(graphs) <= SPACE_GRAPH_SHARE * one_graph, \
        f"space uzh: a process's graph holds {max(graphs):.1f} MiB, over {SPACE_GRAPH_SHARE} of one process's " \
        f"{one_graph:.1f}"


def dryrun_checks(ranks: list) -> None:
    """(c): the ``dryrun_multichip`` twin's losses finite on every process."""
    losses = [[s["loss"] for s in r["dryrun"]] + [r["dryrun3d"]["loss"]] for r in ranks]
    assert all(math.isfinite(v) for row in losses for v in row), f"dryrun losses {losses}"


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *([int(sys.argv[4]), sys.argv[5]] if len(sys.argv) > 4 else []))
