"""One process of a spatially sharded run of the PyTorch port on the CPU
(gloo), for ``tests/test_torch_space.py``; imports torch and the port only.

    python tests/torch_space_worker.py RANK WORLD PORT WORKDIR

Builds the two meshes of ``MESHES`` over the WORLD = 4 processes through
the CLI's flags (``training.cli.make_cli_mesh``), reads its inputs from
``WORKDIR/in.npz``, runs every case below on each mesh (one process start
serves them all) and writes ``WORKDIR/out_<RANK>.npz``, each result under
``<mesh>.<case>.``, then prints ``DONE <RANK>``:

* ``halo.``/``gather.``/``scatter.``: each primitive on this process's
  rows of ``prim.x``, the sum of its output times this process's slot of
  ``prim.<primitive>_cot.<mesh>`` differentiated;
* ``conv.``: ``ops.Conv`` (3x3) on this process's rows of ``conv.x``;
* ``chain.``: ``ops.ConvSeq(norm=False)`` on this process's rows of
  ``chain.x``, the sum of its output times ``chain.cot``'s rows
  differentiated;
* ``bn.``: a train-mode ``BatchNorm`` over the mesh on a replicated level
  (height 3 of the pyramid of ``bn.base``), its loss weighted by ``own``;
* ``<config>.``: one train step of each toy of ``CONFIGS`` on this
  process's images of ``steps.<config>.x``/``.y``: the loss, the gradient,
  the local output shape of every module (``shapes.<module>``) and whether
  the processes hold one state after it;
* ``injected.`` (the data=2, space=2 mesh): one toy PHiSeg step from the
  weights ``injected.w.*`` and the global draws ``injected.aug.*``/
  ``injected.z.*``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from unet_zoo_tpu_torch.data.augment import AugmentOptions, AugmentParams  # noqa: E402
from unet_zoo_tpu_torch.experiments import ExperimentConfig  # noqa: E402

# the meshes over 4 processes, each with the CLI flags that ask for it
MESHES = {"d2s2": ("--mesh", "data=2,space=2"), "d1s4": ("--space", "4")}
AUG = AugmentOptions(do_rotations=True, do_scaleaug=True, do_fliplr=True, do_flipud=True, nlabels=2)
BASE = dict(n_classes=2, image_size=(32, 32), seed=0, batch_size=4, augmentation_options=AUG)
BRATS = dict(model="phiseg3d", data_loader="brats", filter_channels=(2, 4, 4), latent_levels=2, n_classes=3,
             num_labels_per_subject=1, input_channels=4, batch_size=4, image_size=(16, 16, 16), seed=0)
# the toy steps: the f32 U-Net, PHiSeg in the three memory modes (PHiSeg
# plain at 5 levels, 32 -> 2: at space 4 its 2x2 level stays replicated),
# PHiSeg3D at 16^3 and ProbUNet, global batch 4
CONFIGS = {
    "unet": dict(BASE, experiment_name="sp_unet", model="unet", filter_channels=(4, 8, 8)),
    "phiseg": dict(BASE, experiment_name="sp_phiseg", model="phiseg", filter_channels=(4, 8, 8, 8, 8),
                   latent_levels=3),
    "phiseg_remat": dict(BASE, experiment_name="sp_phiseg_remat", model="phiseg", filter_channels=(4, 8, 8),
                         latent_levels=2, reversible_mode="remat"),
    "phiseg_rev": dict(BASE, experiment_name="sp_phiseg_rev", model="phiseg", filter_channels=(4, 8, 8),
                       latent_levels=2, reversible_mode="reversible"),
    "phiseg3d": dict(BRATS, experiment_name="sp_phiseg3d"),
    "prob_unet": dict(BASE, experiment_name="sp_prob_unet", model="prob_unet", filter_channels=(4, 8, 8),
                      latent_dim=3, no_convs_fcomb=3),
}
# the toy of the step against the JAX package (the data-parallel tests' PHiSeg)
INJECTED = dict(BASE, experiment_name="sp_injected", model="phiseg", filter_channels=(4, 8, 8), latent_levels=2)


def shape_hooks(model: torch.nn.Module, shapes: dict) -> list:
    """Records the shape of every module's first rank-4 or rank-5 output,
    in call order, under ``shapes[<module name>]``."""
    def hook(name):
        def record(module, args, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            first = next((t for t in outs if isinstance(t, torch.Tensor) and t.ndim in (4, 5)), None)
            if first is not None:
                shapes.setdefault(name, []).append(tuple(first.shape))
        return record

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]


def step(cfg: dict, mesh, x: np.ndarray, y: np.ndarray, log_dir: str, aug=None, z_eps=None, weights=None) -> dict:
    """One train step of ``cfg`` (``mesh`` None: this process alone, on the
    whole batch) from its seed, or from ``weights``: the loss, the gradient,
    the state after it, the modules' output shapes and, on a mesh, whether
    every process holds the same state."""
    from unet_zoo_tpu_torch.parallel import replicated, shard_batch
    from unet_zoo_tpu_torch.training import Trainer

    tr = Trainer(ExperimentConfig(**cfg), device="cpu", mesh=mesh, tensorboard=False, log_dir=log_dir)
    if weights is not None:
        tr.state.model.load_state_dict(weights)
    shapes: dict = {}
    hooks = shape_hooks(tr.state.model, shapes)
    xi, yi = (x, y) if mesh is None else (shard_batch(mesh, x), shard_batch(mesh, y))
    aux = tr.train_step(torch.from_numpy(xi), torch.from_numpy(yi), aug, z_eps)
    for h in hooks:
        h.remove()
    model = tr.state.model
    out = {"loss": aux["loss"].numpy(), **{f"grad.{n}": p.grad.numpy().copy() for n, p in model.named_parameters()},
           **{f"state.{k}": v.detach().numpy().copy() for k, v in model.state_dict().items()},
           **{f"shapes.{n}": np.asarray(s) for n, s in shapes.items()}}
    if mesh is not None:
        out["replicated"] = np.asarray(replicated(mesh, [*model.parameters(), *model.buffers()]))
    tr.close()
    return out


def primitives(sp, tag: str, inputs: dict, rows: slice, part: slice) -> dict:
    """halo, gather and scatter on this process's rows of ``prim.x``."""
    x = torch.from_numpy(inputs["prim.x"])
    out = {}
    for name in ("halo", "gather", "scatter"):
        t = (x[rows] if name == "scatter" else x[rows][:, part]).clone().requires_grad_()
        y = getattr(sp, name)(t)
        cot = torch.from_numpy(inputs[f"prim.{name}_cot.{tag}"][rows][:, sp.index])
        (y * cot).sum().backward()
        out.update({f"{name}.y": y.detach().numpy(), f"{name}.grad": t.grad.numpy()})
    return out


def ops_cases(sp, mesh, inputs: dict) -> dict:
    """``Conv``, the BN-free chain and BatchNorm on a replicated level."""
    from unet_zoo_tpu_torch import ops
    from unet_zoo_tpu_torch.parallel import batch_spec
    from unet_zoo_tpu_torch.parallel.mesh import sync_batch_norm

    out = {}
    x = torch.from_numpy(inputs["conv.x"])
    rows = batch_spec(mesh, len(x))
    x = x[rows]
    conv = ops.Conv(x.shape[-1], inputs["conv.weight"].shape[0])
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(inputs["conv.weight"]))
        conv.bias.copy_(torch.from_numpy(inputs["conv.bias"]))
        out["conv.y"] = conv(sp.shard(x)).numpy()

    sp.heights.clear()
    x = torch.from_numpy(inputs["chain.x"])[rows]
    n = sum(k.startswith("chain.w") for k in inputs)
    seq = ops.ConvSeq(x.shape[-1], inputs["chain.w0"].shape[0], n, norm=False)
    with torch.no_grad():
        for j in range(n):
            getattr(seq, f"conv{j}").conv.weight.copy_(torch.from_numpy(inputs[f"chain.w{j}"]))
            getattr(seq, f"conv{j}").conv.bias.copy_(torch.from_numpy(inputs[f"chain.b{j}"]))
    xs = sp.shard(x).detach().requires_grad_()
    y = seq(xs)
    (y * torch.from_numpy(inputs["chain.cot"])[rows][:, sp.rows(x.shape[1])]).sum().backward()
    out.update({"chain.y": y.detach().numpy(), "chain.x_grad": xs.grad.numpy(),
                **{f"chain.grad.{k}": p.grad.numpy() for k, p in seq.named_parameters()}})

    sp.heights.clear()
    sp.shard(torch.from_numpy(inputs["bn.base"]))  # records the pyramid, on which height 3 stays replicated
    bn = sync_batch_norm(ops.BatchNorm(inputs["bn.x"].shape[-1]), mesh.group)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn.weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn.bias"]))
    rows = batch_spec(mesh, len(inputs["bn.x"]))
    xb = torch.from_numpy(inputs["bn.x"])[rows].clone().requires_grad_()
    assert not sp.is_sharded(xb)
    y = bn(xb)
    ((y * torch.from_numpy(inputs["bn.cot"])[rows]).sum() * sp.own(y)).backward()
    out.update({"bn.y": y.detach().numpy(), "bn.x_grad": xb.grad.numpy(), "bn.weight_grad": bn.weight.grad.numpy(),
                "bn.bias_grad": bn.bias.grad.numpy(), "bn.mean": bn.running_mean.numpy(),
                "bn.var": bn.running_var.numpy()})
    return out


def main(rank: int, world: int, port: str, workdir: str) -> None:
    import torch.distributed as dist

    from unet_zoo_tpu_torch.parallel import batch_spec, init_distributed
    from unet_zoo_tpu_torch.parallel.space import rows_of, space_sharding
    from unet_zoo_tpu_torch.training import cli

    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    inputs = dict(np.load(os.path.join(workdir, "in.npz")))
    parser = argparse.ArgumentParser()
    cli._common_args(parser)
    meshes = {tag: cli.make_cli_mesh(parser.parse_args(["exp", "--device", "cpu", *flags]), 4)
              for tag, flags in MESHES.items()}
    out = {}
    for tag, mesh in meshes.items():
        assert (mesh.data * mesh.space, mesh.world) == (world, world), mesh
        x = inputs["prim.x"]
        rows, part = batch_spec(mesh, len(x)), rows_of(x.shape[1], mesh.space, mesh.rank % mesh.space)
        with space_sharding(mesh) as sp:
            out.update({f"{tag}.{k}": v for k, v in primitives(sp, tag, inputs, rows, part).items()})
        with space_sharding(mesh) as sp:
            out.update({f"{tag}.{k}": v for k, v in ops_cases(sp, mesh, inputs).items()})
        for name, cfg in CONFIGS.items():
            res = step(cfg, mesh, inputs[f"steps.{name}.x"], inputs[f"steps.{name}.y"],
                       os.path.join(workdir, f"log{rank}"))
            out.update({f"{tag}.{name}.{k}": v for k, v in res.items()})

    mesh = meshes["d2s2"]
    weights = {k[len("injected.w."):]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("injected.w.")}
    draws = AugmentParams(*(torch.from_numpy(inputs[f"injected.aug.{f}"]) for f in AugmentParams._fields))
    z_eps = [torch.from_numpy(inputs[f"injected.z.{lvl}"]) for lvl in range(INJECTED["latent_levels"])]
    res = step(INJECTED, mesh, inputs["injected.x"], inputs["injected.y"], os.path.join(workdir, f"log{rank}"),
               draws, z_eps, weights)
    out.update({f"injected.{k}": v for k, v in res.items()})

    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
