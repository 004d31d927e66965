"""The training harness, the twin of ``unet_zoo_tpu.training.trainer.Trainer``
(the U-Net, ProbUNet, PHiSeg and PHiSeg3D families, 2D and 3D device
augmentation, one card, or one card a process over a data-parallel mesh).

The train step, all on the device and with no host sync: augmentation
(draws from the state's generator) -> the model in train mode (the U-Net's
and ProbUNet's trunk blocks through the conv-chain kernel; ProbUNet and
PHiSeg with the mask, their z noise drawn from the same generator after
the augmentation's, their BatchNorm running statistics updated in the
forward) -> the family's loss ->
backward -> the plateau scheduler on this step's loss -> coupled-L2 Adam
at the scheduler's learning rate, in the JAX step's order.

Around it: the iteration loop (``train``, which syncs with the host only
to log), periodic multi-sample validation with GED, variance-NCC and Dice
on the device (``validate``) and best-per-metric checkpoints, the
quantitative test sweep (``test``) with its npz dump, and full-state
checkpoints under the reference's names (``validation_ckpt``,
``best_{dice,loss,ged,ncc}``, ``last``). A 3D BraTS experiment (one-hot
WT/TC/ET labels) validates and tests a volume at a time (``eval_volume``:
per-region Dice, sensitivity and specificity on the device, HD95 on the
host; ``validate_brats``, ``test_brats``) and exports its predictions as
NIfTI label maps (``export_predictions``). The JAX package uploads and
enqueues every image or volume before it fetches any; here a 2D split goes
up ``EVAL_IMAGE_WINDOW`` images at a time (labels as uint8, widened on the
card), and at most ``EVAL_WINDOW`` windows of images, or volumes, are in
flight, each fetched into page-locked memory behind an event, so the host
reads one while the card computes the next.

With ``augment_on="host"`` the loop feeds from a ``PrefetchingLoader``
(``data/augment_host.py``: the cv2 chain on a host thread pool, drawn from
``host_rng``, which is seeded alike on every process) and the step does not
warp on the device; without cv2 the Trainer raises at construction. A 2D
PHiSeg evaluation above ``EVAL_SAMPLE_PIXELS`` samples x pixels decodes its
samples ``EVAL_SAMPLE_CHUNK`` at a time from the whole fold's noise
(``sample_chunk``). ``generate_images`` writes PNGs of test images, their
ground truth and samples (``utils/png.py``).

Data parallelism (``mesh``, ``parallel.make_mesh``; one process alone holds
``parallel.local_mesh``), the twin of the JAX ``Trainer(mesh=...)``, which
jits the one-device step on the global batch with sharded inputs: every
process reads the same global batch from its
identically seeded provider and keeps its rows (``parallel.shard_batch``);
it draws the global batch's augmentation and z noise from the state's
generator, which is equal on every process, and keeps its rows of them;
BatchNorm's train-mode statistics are the group's (at world > 1); the
gradients are averaged over the processes in one flat all-reduce after the
backward, and the loss terms before the plateau scheduler, so every process
takes the same Adam step at the same learning rate. Every loss term is a
batch mean of per-image sums, so the mean of equal shards' gradients is the
global batch's gradient: a step at any world size computes the one-process
step on the global batch, up to float32 summation order. At world 1 every
collective returns at once, and the step is bit for bit the one in which
the model draws its own z noise. Process 0 alone validates, logs and writes checkpoints and
metrics; evaluation runs every model in eval mode and issues no collective.

Spatial sharding (a mesh with space > 1, ``parallel/space.py``), the twin of
the JAX ``Trainer``'s ``space_sharding`` around its step: the augmentation
and the forward run inside ``space_sharding(mesh)``. Each process of a data
group warps the group's whole images with the same draws, then keeps its
rows of the height (the warp's 4-tap gather reads across the rows'
edges), and decodes its rows of each level of the global z noise; the
convs exchange halos, and every loss term is this process's part of its
data group's. The gradients are then summed over the space axis and
averaged over the data axis. The backward runs outside the context:
whatever it runs again holds the forward's ``Space``.

Evaluation draws its z noise from a device generator seeded from (seed,
step, salt, image index) (``eval_generator``), never from the train
state's generator, as the JAX package derives each image's key with
``fold_in`` and leaves ``state.rng`` alone: a validation changes nothing
of the training run that follows it. Annotator picks come from a numpy
generator seeded as the JAX package seeds it (``_eval_rng``).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from unet_zoo_tpu_torch import metrics as M
from unet_zoo_tpu_torch.data.augment import (
    Augment3DParams,
    AugmentParams,
    sample_augment_3d_params,
    sample_augment_params,
    take_rows,
    warp_batch_2d,
    warp_batch_3d,
)
from unet_zoo_tpu_torch.experiments.config import ExperimentConfig, SystemConfig
from unet_zoo_tpu_torch.models.registry import get_model
from unet_zoo_tpu_torch.ops.conv import chain_route
from unet_zoo_tpu_torch.parallel import space as space_lib
from unet_zoo_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads_,
    barrier,
    batch_spec,
    local_mesh,
    mean_over_processes,
    process_index,
    replicated,
    shard_batch,
    sync_batch_norm,
)
from unet_zoo_tpu_torch.training.schedule import plateau_init, plateau_update
from unet_zoo_tpu_torch.training.state import TrainState, restore_checkpoint, save_checkpoint
from unet_zoo_tpu_torch.utils.summary import MetricsWriter

log = logging.getLogger(__name__)

# the scalar results of one evaluated image, in the order of a row of
# ``Trainer.evaluate_images``; the per-class Dice follows them
EVAL_SCALARS = ("ged", "ncc", "loss", "kl", "recon")
# windows of 2D images, or BraTS volumes, evaluated ahead of the one the host reads
EVAL_WINDOW = 2
# 2D images uploaded and evaluated at a time by ``validate`` and ``test``: at
# 512x512 with 6 annotators an image's labels take 1.5 MiB as uint8 and 12
# MiB widened to int64, and a UZH validation takes "all" images
EVAL_IMAGE_WINDOW = 8
# validation images drawn as panels (input / the chosen annotator / mean prediction / one sample)
PANELS = 4
# samples a BraTS volume decodes at a time: at 128^3 a 16-sample fold decoded
# whole peaks near 47 GiB of the card's 80, 4 at a time near 14 GiB, in the
# same time (``chip_smoke.py`` phase 10 (c), PERF.md)
VOLUME_SAMPLE_CHUNK = 4
# a 2D PHiSeg fold above EVAL_SAMPLE_PIXELS samples x pixels decodes
# EVAL_SAMPLE_CHUNK samples at a time; the LIDC 100-sample fold at 128x128
# stays whole. At 512x512 in float32 with TF32 off, cuDNN's convolution
# workspace sets the peak of a fold of 2 to 16 samples near 31-35 GiB, and
# chunks of 2 to 6 run several times slower than the whole fold; one sample
# at a time peaks near 1 GiB in the whole fold's time (NVIDIA H100 80GB HBM3,
# 700 W; tools/torch_sample_chunks.py, PERF.md)
EVAL_SAMPLE_PIXELS = 100 * 128 * 128
EVAL_SAMPLE_CHUNK = 1
# the eval_generator salt of generate_images (validation takes 0, test 1)
GENERATE_SALT = 2
BRATS_REGIONS = ("wt", "tc", "et")
# the latent families: z noise in the step, a loss on the mask
LATENT_FAMILIES = ("phiseg", "phiseg3d", "prob_unet")

AnyAugmentParams = Union[AugmentParams, Augment3DParams]


def image_metrics(logits: torch.Tensor, y_all: torch.Tensor, y_chosen: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics of one image's samples: ``logits`` (n, *S, C), the
    annotators' labels ``y_all`` (A, *S) and the chosen annotator's
    ``y_chosen`` (*S). Softmax and argmax in float32 with the class axis
    first, as the JAX package computes them; GED of the sampled labels
    against every annotator, variance-NCC, and the Dice of the mean
    prediction's argmax against the chosen annotator. Returns device
    tensors: ``ged``, ``ncc``, ``dice`` (C,), and the int32 maps
    ``mean_pred`` and ``sample0`` (the first sample's labels)."""
    n_classes = logits.shape[-1]
    logits_cf = logits.float().movedim(-1, 0)  # (C, n, *S)
    probs_cf = torch.softmax(logits_cf, dim=0)
    pred_labels = logits_cf.argmax(0)  # (n, *S)
    ged = M.generalised_energy_distance(pred_labels, y_all, nlabels=n_classes - 1, label_range=range(1, n_classes))
    gt_cf = torch.stack([(y_all == c).float() for c in range(n_classes)])  # (C, A, *S)
    ncc = M.variance_ncc_dist_class_first(probs_cf, gt_cf)
    mean_pred = probs_cf.mean(1).argmax(0)
    dice = M.dice_per_label(mean_pred, y_chosen, n_classes)
    return {"ged": ged, "ncc": ncc, "dice": dice, "mean_pred": mean_pred.int(), "sample0": pred_labels[0].int()}


def adam_coupled_l2(params, lr: float, weight_decay: float = 0.0, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """``torch.optim.Adam(weight_decay=wd)``: the L2 term is coupled, added
    to the gradient before the moments, which is the JAX package's
    ``add_decayed_weights -> scale_by_adam`` chain. The learning rate is a
    0-d tensor on the parameters' device, which the fused implementation
    reads on the device, so the scheduler can write it each step with no
    sync."""
    params = list(params)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr_t, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay, fused=True)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None, seed: Optional[int] = None,
                 sys_config: Optional[SystemConfig] = None, log_dir: Optional[str] = None, tensorboard: bool = True,
                 tf32: bool = False, mesh: Optional[Mesh] = None):
        """Builds the model (weights drawn on the CPU from a generator
        seeded from ``seed``, default ``cfg.seed``, then moved to
        ``device``, by default the CUDA card), the optimizer and the train
        state, whose device generator makes every draw of a step; creates
        the log directory (default ``log_root/log_dir_name/experiment_name``
        of ``sys_config``) with its train and validation metrics streams,
        and loads ``cfg.pretrained_model`` from it where that file exists.
        Raises where no card is present and ``device`` is not given.

        Sets the process's float32 precision: with ``tf32`` False (the
        default) cuDNN convolutions and float32 matmuls run in float32, not
        TF32 (PyTorch's default lets cuDNN take TF32, ~1e-3 of max|ref| off
        on the U-Net, beyond the 1e-4 the card's f32 parity checks hold): a
        float32 experiment then computes what the CPU and the tests compute,
        and a bf16 one keeps its float32 parts (BatchNorm statistics, losses,
        metrics) in float32. Both flags are logged beside the chain route.

        ``mesh`` (``parallel.make_mesh``; by default ``parallel.local_mesh``
        on ``device``, this process alone) makes the step data-parallel over
        its processes, each on the mesh's device: ``cfg.batch_size`` is the
        global batch and must split evenly over them. Every process must
        build its Trainer from the same configuration and seed; at world > 1
        the BatchNorm statistics are the group's, and the construction
        checks that every process holds the same state (raises if not).
        Only process 0 of the process group (the one process where there is
        none) creates the log directory and the metrics streams."""
        cfg.validate()
        self.cfg = cfg
        if mesh is None:
            mesh = local_mesh(device)
        elif device is not None and torch.device(device) not in (mesh.device, torch.device(mesh.device.type)):
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        batch_spec(mesh, cfg.batch_size)  # raises where the batch does not split
        self.mesh = mesh
        self.is_main = process_index() == 0
        self.device = mesh.device
        self.sys_config = sys_config or SystemConfig()
        self.log_dir = log_dir or os.path.join(self.sys_config.log_root, cfg.log_dir_name, cfg.experiment_name)
        if self.is_main:
            os.makedirs(self.log_dir, exist_ok=True)
        self.seed = cfg.seed if seed is None else seed
        # the host augmentation's draws (augment_on="host"), seeded alike on every process
        self.host_rng = np.random.default_rng(self.seed)
        if cfg.augment_on == "host":
            from unet_zoo_tpu_torch.data.augment_host import _cv2

            _cv2()  # raises an ImportError naming cv2 where it is missing: no fallback to the device
        # two seeds split from one, as the JAX trainer splits its root key
        k_params, k_aug = torch.randint(2 ** 62, (2,), generator=torch.Generator().manual_seed(self.seed)).tolist()
        model_kwargs = cfg.model_kwargs()
        model = get_model(cfg.model, **model_kwargs, device=self.device,
                          generator=torch.Generator().manual_seed(k_params))
        # the BN-free conv chains (the U-Net's plain and remat blocks): the
        # hand-written kernel of the compute dtype, or the CPU's plain version
        self.chain_route = chain_route(model_kwargs["dtype"] or torch.float32, self.device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = self.tf32 = tf32
        log.info("%s: %s, memory mode %s, %s compute on %s; BN-free conv chains run on: %s; TF32 in cuDNN "
                 "convolutions and float32 matmuls: %s", cfg.experiment_name, cfg.model, cfg.effective_reversible_mode,
                 cfg.dtype, self.device, self.chain_route, "on" if tf32 else "off")
        self.state = TrainState(
            model=model,
            optimizer=adam_coupled_l2(model.parameters(), cfg.learning_rate, cfg.weight_decay),
            sched=plateau_init(cfg.learning_rate, self.device),
            generator=torch.Generator(device=self.device).manual_seed(k_aug),
        )
        if mesh.world > 1:
            sync_batch_norm(model, mesh.group)
            state = [*model.parameters(), *model.buffers(), self.state.generator.get_state()]
            if not replicated(mesh, state):
                raise RuntimeError("the processes' train states differ: every process must build its Trainer from "
                                   "the same configuration and seed")
            log.info("process %d of %d: global batch %d, %d a process; BatchNorm statistics over the group",
                     mesh.rank, mesh.world, cfg.batch_size, cfg.batch_size // mesh.data)
        self.iteration = 0
        self.best = {"dice": -1.0, "loss": math.inf, "ged": math.inf, "ncc": -1.0}
        # the metrics streams are process 0's (None elsewhere)
        self.training_writer = self.validation_writer = None
        if self.is_main:
            self.training_writer = MetricsWriter(self.log_dir, "train", tensorboard=tensorboard)
            self.validation_writer = MetricsWriter(self.log_dir, "validation", tensorboard=tensorboard)
        if cfg.pretrained_model is not None:
            path = os.path.join(self.log_dir, cfg.pretrained_model)
            if os.path.exists(path):
                log.info("loading pretrained model %s", path)
                restore_checkpoint(path, self.state)
            else:  # the reference goes on from scratch
                log.info("pretrained %s not found; training from scratch", path)

    # the phases of one step, in order (``chip_smoke.py`` times each)

    def _global(self, batch: int) -> Tuple[int, slice]:
        """(the global batch, this process's rows of it) for a local batch."""
        total = batch * self.mesh.data
        return total, batch_spec(self.mesh, total)

    def augment(self, x: torch.Tensor, y: torch.Tensor,
                aug_params: Optional[AnyAugmentParams] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Move the batch to the device and warp it with ``aug_params``
        (``AugmentParams``, or ``Augment3DParams`` for a 3D experiment), or
        with draws from the state's generator. x and y are this process's
        data group's images, whole, and the draws, given or drawn, are the
        global batch's, of which it keeps its rows (all of them in one
        process). With ``augment_on="host"`` the batch arrives augmented
        (``train``'s ``PrefetchingLoader``) and is only moved. Under spatial
        sharding it returns this process's rows of the height of the
        augmented images and labels."""
        x, y = self._warp(x.to(self.device), y.to(self.device), aug_params)
        sp = space_lib.current()
        return (x, y) if sp is None else sp.shard(x, y)

    def _warp(self, x: torch.Tensor, y: torch.Tensor, aug_params) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.cfg.augment_on == "host":
            return x, y
        total, rows = self._global(x.shape[0])
        if self.cfg.is_3d:
            opts = self.cfg.augmentation_options_3d
            if opts is None:
                return x, y
            if aug_params is None:
                aug_params = sample_augment_3d_params(self.state.generator, total, x.shape[-1], opts, self.device)
            return warp_batch_3d(x, y, take_rows(aug_params, rows), opts)
        opts = self.cfg.augmentation_options
        if opts is None:
            return x, y
        if aug_params is None:
            aug_params = sample_augment_params(self.state.generator, total, tuple(x.shape[1:3]), opts, self.device)
        return warp_batch_2d(x, y, take_rows(aug_params, rows), opts)

    def forward_loss(self, x: torch.Tensor, y: torch.Tensor, z_eps=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The model in train mode (an evaluation may have left it in eval
        mode) and its loss. ``z_eps`` replaces the posterior's z noise: for
        PHiSeg one tensor a latent level, for ProbUNet one (B, latent_dim)
        tensor. The noise, given or drawn from the state's generator
        (``model.train_noise``, in the forward's own order), is the global
        batch's, and this process decodes its rows: of the batch, and under
        spatial sharding of each level's height where it is sharded."""
        model = self.state.model
        model.train()
        if self.cfg.model not in LATENT_FAMILIES:
            return model.loss(model(x), y)
        total, rows = self._global(x.shape[0])
        if z_eps is None:
            z_eps = model.train_noise(total, space_lib.global_spatial(x), self.state.generator, self.device)
        sp = space_lib.current()
        if isinstance(z_eps, (list, tuple)):
            z_eps = [e[rows] if sp is None else sp.shard(e[rows]) for e in z_eps]
        else:
            z_eps = z_eps[rows]
        return model.loss(model(x, y, post_eps=z_eps, generator=self.state.generator), y)

    def backward(self, loss: torch.Tensor) -> None:
        """The gradients of ``loss``, each its mean over the mesh's
        processes (one all-reduce of every gradient in one flat buffer)."""
        self.state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(self.mesh, self.state.model.parameters())

    def update(self, loss: torch.Tensor) -> None:
        """The plateau scheduler on this step's loss (its mean over the
        mesh's processes, so that every process keeps one learning rate),
        then Adam at its rate."""
        self._update(mean_over_processes(self.mesh, {"loss": loss})["loss"])

    def _update(self, loss: torch.Tensor) -> None:
        cfg, state = self.cfg, self.state
        state.sched = plateau_update(state.sched, loss, factor=cfg.lr_plateau_factor,
                                     patience=cfg.lr_plateau_patience, min_lr=cfg.min_lr)
        for group in state.optimizer.param_groups:
            group["lr"].copy_(state.sched.lr)
        state.optimizer.step()
        state.step += 1

    def train_step(self, x: torch.Tensor, y: torch.Tensor, aug_params: Optional[AnyAugmentParams] = None,
                   z_eps=None) -> Dict[str, torch.Tensor]:
        """One step on images x (B, *S, C) float and labels y: (B, *S) int,
        or for a 3D BraTS experiment (B, *S, 3) one-hot float WT/TC/ET.
        ``aug_params`` (``AugmentParams``, ``Augment3DParams``) and ``z_eps``
        (ProbUNet, PHiSeg) replace the step's own draws (tests inject the JAX
        package's). x and y are this process's rows of the global batch,
        and ``aug_params`` and ``z_eps`` the global batch's; under spatial
        sharding x and y hold the whole height. Returns the loss's aux dict
        as device tensors, the global batch's means."""
        with space_lib.space_sharding(self.mesh):
            x, y = self.augment(x, y, aug_params)
            loss, aux = self.forward_loss(x, y, z_eps)
        self.backward(loss)
        aux = mean_over_processes(self.mesh, aux)
        self._update(aux["loss"])
        return aux

    # the train loop

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host batch on the device. From page-locked memory the copy is
        asynchronous, so the loop does not wait for the device."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def train(self, data, iterations: Optional[int] = None, validate: bool = True) -> Optional[Dict[str, torch.Tensor]]:
        """Runs the iteration loop up to ``iterations`` (default
        ``cfg.iterations``) steps in all, from the state's step, so a
        resumed trainer goes on toward the same total. Validates every
        ``validation_frequency`` iterations and logs every
        ``logging_frequency``; logging is the loop's only host sync. Every
        process reads the global batch and steps on its rows; process 0
        alone validates and logs, the others go on to the next step's first
        collective and wait there; all meet at a barrier at the end. Returns
        the last step's aux dict (device tensors), or None if there was
        nothing to do."""
        cfg = self.cfg
        n_iter = iterations if iterations is not None else cfg.iterations
        start = self.state.step
        if start >= n_iter:
            log.info("state already at step %d >= %d; nothing to do", start, n_iter)
            return None
        log.info("starting training: filters=%s batch=%d", cfg.filter_channels, cfg.batch_size)
        source, loader = data.train, None
        host_opts = cfg.augmentation_options_3d if cfg.is_3d else cfg.augmentation_options
        if cfg.augment_on == "host" and host_opts is not None:
            from unet_zoo_tpu_torch.data.augment_host import PrefetchingLoader

            # every process draws and augments the same global batch, then takes its rows
            source = loader = PrefetchingLoader(data.train, cfg.batch_size, opts=host_opts, rng=self.host_rng)
        last_aux = None
        try:
            for self.iteration in range(start + 1, n_iter + 1):
                x, y = source.next_batch(cfg.batch_size)
                last_aux = self.train_step(self._to_device(shard_batch(self.mesh, x)),
                                           self._to_device(shard_batch(self.mesh, y)))
                if not self.is_main:
                    continue
                if validate and self.iteration % cfg.validation_frequency == 0:
                    self.validate(data)
                if self.iteration % cfg.logging_frequency == 0:
                    values = {k: float(last_aux[k]) for k in ("loss", "kl", "recon")}
                    values["lr"] = float(self.state.sched.lr)
                    log.info("iteration %d loss %.5f", self.iteration, values["loss"])
                    self.training_writer.scalars(self.iteration, values)
        finally:
            if loader is not None:
                loader.close()
        barrier("train")
        log.info("finished training.")
        return last_aux

    # evaluation

    def _eval_rng(self, salt: int = 0) -> np.random.Generator:
        """Host RNG for eval-time annotator picks, derived from (seed,
        iteration, salt) only, as in the JAX package."""
        return np.random.default_rng([self.seed, self.iteration, salt])

    def eval_generator(self, salt: int, index: int) -> torch.Generator:
        """The z noise of evaluated image ``index``: a device generator
        seeded from (seed, step, salt, index), never the train state's
        generator, so an evaluation leaves the training run as it was."""
        seq = np.random.SeedSequence([self.seed, self.state.step, salt, index])
        return torch.Generator(device=self.device).manual_seed(int(seq.generate_state(1, np.uint64)[0]))

    def _annotators(self) -> List[int]:
        cfg = self.cfg
        return list(cfg.annotator_range) if cfg.annotator_range is not None else list(range(cfg.num_labels_per_subject))

    def sample_chunk(self, x: torch.Tensor, n_samples: int) -> Optional[int]:
        """Samples a PHiSeg fold of ``x`` (1, *S, C) decodes at a time: for a
        volume ``VOLUME_SAMPLE_CHUNK``; for an image all of them (None) up to
        ``EVAL_SAMPLE_PIXELS`` samples x pixels, else ``EVAL_SAMPLE_CHUNK``."""
        if self.cfg.is_3d:
            return VOLUME_SAMPLE_CHUNK
        return None if n_samples * math.prod(x.shape[1:-1]) <= EVAL_SAMPLE_PIXELS else EVAL_SAMPLE_CHUNK

    def _sample(self, x: torch.Tensor, n_samples: int, generator: Optional[torch.Generator], eps=None
                ) -> torch.Tensor:
        """``model.sample(x, n_samples)`` of the family: the U-Net's n equal
        predictions, ProbUNet's and PHiSeg's prior samples from ``eps`` or
        ``generator`` (PHiSeg's decoded ``sample_chunk`` samples at a time,
        its whole fold's noise drawn first, so the chunks decode what the
        whole fold does)."""
        model, family = self.state.model, self.cfg.model
        if family == "unet":
            return model.sample(x, n_samples)
        if family == "prob_unet":
            return model.sample(x, n_samples, eps=eps, generator=generator)
        return model.sample(x, n_samples, eps=eps, generator=generator, chunk=self.sample_chunk(x, n_samples))

    def eval_image(self, x: torch.Tensor, y_all: torch.Tensor, y_chosen: torch.Tensor, n_samples: int,
                   n_loss: int = 1, salt: int = 0, index: int = 0, eps=None, loss_eps=None) -> Dict[str, torch.Tensor]:
        """One image's evaluation, the twin of the JAX ``_eval_image_fn``:
        x (1, *S, C) float, y_all (A, *S) and y_chosen (1, *S) int, on the
        device. ``model.sample(x, n_samples)`` -> ``image_metrics``, and the
        eval-mode loss against ``y_chosen``: for ProbUNet and PHiSeg
        ``model(x, y)`` in eval mode (BatchNorm on running statistics;
        ProbUNet decodes the posterior's z, PHiSeg the prior's) on the batch
        of ``n_loss`` repeats, each with its own z; for the U-Net, which is
        deterministic in eval mode, the loss of the sample's logits (the JAX
        package runs the forward once more). The z noise comes from
        ``eval_generator(salt, index)``, or ``eps`` (for ``sample``) and
        ``loss_eps`` (ProbUNet: the posterior's (n_loss, latent_dim);
        PHiSeg: (posterior, prior) lists) replace it. PHiSeg decodes its
        samples ``sample_chunk`` at a time, which bounds the memory of a
        large fold (100 samples at 512x512) and gives the whole fold's
        logits. Makes no host sync; returns device tensors ``ged``,
        ``ncc``, ``dice``, ``loss``, ``kl``, ``recon``, ``mean_pred`` and
        ``sample0``."""
        model = self.state.model
        family = self.cfg.model
        stochastic = family in ("phiseg", "prob_unet")
        generator = self.eval_generator(salt, index) if stochastic else None
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = self._sample(x, n_samples, generator, eps)
                out = image_metrics(logits[0], y_all, y_chosen[0])
                if stochastic:
                    x_rep, y_rep = x.repeat(n_loss, 1, 1, 1), y_chosen.repeat(n_loss, 1, 1)
                    if family == "phiseg":
                        post_eps, prior_eps = loss_eps if loss_eps is not None else (None, None)
                        loss_out = model(x_rep, y_rep, post_eps=post_eps, prior_eps=prior_eps, generator=generator)
                    else:
                        loss_out = model(x_rep, y_rep, post_eps=loss_eps, generator=generator)
                    loss, aux = model.loss(loss_out, y_rep)
                else:
                    loss, aux = model.loss(logits[:, 0], y_chosen)
        finally:
            model.train(was_training)
        out.update(loss=loss, kl=aux["kl"], recon=aux["recon"])
        return out

    def _upload(self, split, start: int, stop: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images ``start:stop`` of ``split`` (``images`` (N, *S), ``labels``
        (N, *S, A)) on the device: images (n, *S, 1) float32 and labels (n,
        A, *S), copied as uint8 and widened to int64 there."""
        # copies: a memory-mapped cache gives read-only views
        images = np.array(split.images[start:stop], dtype=np.float32)[..., None]
        labels = np.array(np.moveaxis(np.asarray(split.labels[start:stop]), -1, 1), dtype=np.uint8, order="C")
        return self._to_device(images), self._to_device(labels).long()

    def evaluate_images(self, images: torch.Tensor, labels: torch.Tensor, chosen: List[int], n_samples: int,
                        n_loss: int, salt: int, first_index: int = 0, n_maps: int = 0
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``eval_image`` of every uploaded image against annotator
        ``chosen[i]``, all issued before anything is fetched: no host sync.
        Returns device tensors: (n, 5 + C) float32 rows (``EVAL_SCALARS``,
        then the per-class Dice) and the (n_maps, 2, *S) maps mean_pred and
        sample0 of the first ``n_maps`` images (None for none)."""
        rows, maps = [], []
        with torch.inference_mode():
            for ii, a in enumerate(chosen):
                out = self.eval_image(images[ii:ii + 1], labels[ii], labels[ii, a:a + 1], n_samples, n_loss, salt,
                                      first_index + ii)
                rows.append(torch.cat([torch.stack([out[k].float() for k in EVAL_SCALARS]), out["dice"]]))
                if ii < n_maps:
                    maps.append(torch.stack([out["mean_pred"], out["sample0"]]))
            return torch.stack(rows), torch.stack(maps) if maps else None

    def stream_images(self, split, chosen: List[int], n_samples: int, n_loss: int, salt: int, first_index: int = 0,
                      n_maps: int = 0) -> Iterator[Tuple[Dict[str, torch.Tensor], int]]:
        """``evaluate_images`` of images 0..len(chosen)-1 of ``split``,
        uploaded ``EVAL_IMAGE_WINDOW`` at a time, image i with noise index
        ``first_index + i`` and the maps of the first ``n_maps``, through
        ``_fetched``: yields (a window's host results ``rows`` and, where it
        has any, ``maps``; its first image) in order."""
        def issued():
            for start in range(0, len(chosen), EVAL_IMAGE_WINDOW):
                stop = min(start + EVAL_IMAGE_WINDOW, len(chosen))
                images, labels = self._upload(split, start, stop)
                rows, maps = self.evaluate_images(images, labels, chosen[start:stop], n_samples, n_loss, salt,
                                                  first_index + start, n_maps=n_maps - start)
                yield ({"rows": rows} if maps is None else {"rows": rows, "maps": maps}), start

        return self._fetched(issued())

    def _fetched(self, issued: Iterator[Tuple[Dict[str, torch.Tensor], object]]) -> Iterator[tuple]:
        """(host results, tag) for each (device results, tag) that ``issued``
        yields, in order: each copied into page-locked memory behind an event
        as soon as it is issued, at most ``EVAL_WINDOW`` in flight, and
        yielded once its copies are done, while the card works on the next."""
        def landed(host, event, tag):
            if event is not None:
                event.synchronize()
            return host, tag

        pending = collections.deque()
        for out, tag in issued:
            pending.append((*self._to_host(out), tag))
            if len(pending) >= EVAL_WINDOW:
                yield landed(*pending.popleft())
        while pending:
            yield landed(*pending.popleft())

    def validate(self, data) -> Dict[str, float]:
        """Saves ``validation_ckpt``, evaluates ``num_validation_images``
        validation images with ``validation_samples`` samples (and as many
        loss repeats), fetches the results once, keeps the best-per-metric
        checkpoints, writes the aggregates and returns them. A 3D BraTS
        experiment goes to ``validate_brats``."""
        cfg = self.cfg
        if self._is_brats():
            return self.validate_brats(data)
        t0 = time.time()
        self.save_model("validation_ckpt")
        self._log_memory()
        n_total = data.validation.images.shape[0]
        n_val = n_total if cfg.num_validation_images == "all" else min(cfg.num_validation_images, n_total)
        val_rng, annotators = self._eval_rng(), self._annotators()
        chosen = [int(val_rng.choice(annotators)) for _ in range(n_val)]
        n_panels = min(PANELS, n_val) if self.validation_writer.tensorboard else 0
        rows, panels = [], []
        for host, _ in self.stream_images(data.validation, chosen, cfg.validation_samples, cfg.validation_samples,
                                          salt=0, n_maps=n_panels):
            rows.append(host["rows"].numpy())
            if "maps" in host:
                panels.append(host["maps"].numpy())
        rows = np.concatenate(rows)

        if n_panels:
            nlab = max(cfg.n_classes - 1, 1)
            panels = np.concatenate(panels)
            for ii in range(n_panels):
                x = np.asarray(data.validation.images[ii], dtype=np.float32)
                lo, hi = float(x.min()), float(x.max())
                panel = [(x - lo) / max(hi - lo, 1e-8), np.asarray(data.validation.labels[ii])[..., chosen[ii]] / nlab,
                         panels[ii, 0] / nlab, panels[ii, 1] / nlab]
                self.validation_writer.image(self.iteration, f"panel_{ii}", np.concatenate(panel, axis=1))

        agg = {k: float(np.mean(rows[:, i])) for i, k in enumerate(EVAL_SCALARS)}
        dice_arr = rows[:, len(EVAL_SCALARS):]  # (n, C)
        agg["dice"] = float(dice_arr.mean())
        agg["foreground_dice"] = float(dice_arr[:, 1:].mean())
        log.info("validation @%d: dice %.4f fg-dice %.4f elbo %.4f ged %.4f ncc %.4f (%.1fs)", self.iteration,
                 agg["dice"], agg["foreground_dice"], agg["loss"], agg["ged"], agg["ncc"], time.time() - t0)

        # best-per-metric checkpoints, with the JAX package's comparisons
        mean_dice = float(dice_arr.mean(axis=0).mean())
        if mean_dice >= self.best["dice"]:
            self.best["dice"] = mean_dice
            self.save_model("best_dice")
        if agg["loss"] <= self.best["loss"]:
            self.best["loss"] = agg["loss"]
            self.save_model("best_loss")
        if agg["ged"] <= self.best["ged"]:
            self.best["ged"] = agg["ged"]
            self.save_model("best_ged")
        if agg["ncc"] >= self.best["ncc"]:
            self.best["ncc"] = agg["ncc"]
            self.save_model("best_ncc")
        self.validation_writer.scalars(self.iteration, agg)
        return agg

    def test(self, data, num_repeats: int = 10, num_samples: int = 10, checkpoint: Optional[str] = "best_loss",
             save_npz: bool = True) -> Dict[str, object]:
        """The quantitative sweep: restores ``checkpoint`` from the log
        directory (raises ``FileNotFoundError`` if it is missing), then
        ``num_repeats`` passes over the test set with ``num_samples``
        samples an image, each pass fetched once. Writes
        ``test_results.npz`` (``ged`` and ``ncc`` (R, N), ``dice`` (R, N,
        C)) and returns the means and standard deviations and the seconds
        it took. A 3D BraTS experiment goes to ``test_brats``."""
        cfg = self.cfg
        if self._is_brats():
            return self.test_brats(data, num_repeats, num_samples, checkpoint, save_npz)
        self._restore_for_test(checkpoint)
        n_images = data.test.images.shape[0]
        test_rng, annotators = self._eval_rng(salt=1), self._annotators()
        ged_mat = np.zeros((num_repeats, n_images))
        ncc_mat = np.zeros((num_repeats, n_images))
        dice_mat = np.zeros((num_repeats, n_images, cfg.n_classes))
        t0 = time.time()
        for rep in range(num_repeats):
            chosen = [int(test_rng.choice(annotators)) for _ in range(n_images)]
            for host, first in self.stream_images(data.test, chosen, num_samples, 1, salt=1,
                                                  first_index=rep * n_images):
                rows = host["rows"].numpy()
                sl = slice(first, first + len(rows))
                ged_mat[rep, sl], ncc_mat[rep, sl] = rows[:, 0], rows[:, 1]
                dice_mat[rep, sl] = rows[:, len(EVAL_SCALARS):]
        results = {
            "ged": (float(ged_mat.mean()), float(ged_mat.std())),
            "ncc": (float(ncc_mat.mean()), float(ncc_mat.std())),
            "dice": (float(dice_mat.mean()), float(dice_mat.std())),
            "seconds": time.time() - t0,
        }
        log.info("test: GED %.4f±%.4f NCC %.4f±%.4f Dice %.4f±%.4f", *results["ged"], *results["ncc"],
                 *results["dice"])
        if save_npz:
            np.savez(os.path.join(self.log_dir, "test_results.npz"), ged=ged_mat, ncc=ncc_mat, dice=dice_mat)
        return results

    # BraTS (3D) evaluation

    def _is_brats(self) -> bool:
        return self.cfg.is_3d and self.cfg.data_loader == "brats"

    def _restore_for_test(self, checkpoint: Optional[str]) -> None:
        if checkpoint is not None:
            path = os.path.join(self.log_dir, checkpoint)
            if not os.path.exists(path):
                raise FileNotFoundError(f"checkpoint '{checkpoint}' not found in {self.log_dir}")
            restore_checkpoint(path, self.state)

    def eval_volume(self, x: torch.Tensor, y: torch.Tensor, n_samples: int, salt: int = 0, index: int = 0,
                    eps=None, loss_eps=None) -> Dict[str, torch.Tensor]:
        """One BraTS volume's evaluation, the twin of the JAX
        ``_eval_volume_fn``: x (1, D, H, W, C) float and its one-hot WT/TC/ET
        labels y (1, D, H, W, 3) on the device. The mean softmax of
        ``model.sample(x, n_samples)`` (float32; decoded
        ``VOLUME_SAMPLE_CHUNK`` samples at a time) thresholded at 0.5 is the
        prediction; per region its Dice, sensitivity and specificity against
        y, and the eval-mode loss of ``model(x, y)``. The z noise comes from
        ``eval_generator(salt, index)``, or ``eps`` (for ``sample``) and
        ``loss_eps`` ((posterior, prior) lists) replace it. Makes no host
        sync; returns device tensors ``dice``, ``sens``, ``spec`` (3,),
        ``loss``, ``kl``, ``recon`` and the bool ``pred_bin`` (D, H, W, 3)."""
        model = self.state.model
        generator = self.eval_generator(salt, index)
        post_eps, prior_eps = loss_eps if loss_eps is not None else (None, None)
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = self._sample(x, n_samples, generator, eps)
                mean_probs = torch.softmax(logits[0].float(), dim=-1).mean(0)
                regions = range(y.shape[-1])
                out = {
                    "dice": torch.stack([M.dice_binary(mean_probs[..., c] > 0.5, y[0, ..., c]) for c in regions]),
                    "sens": torch.stack([M.sensitivity(mean_probs[..., c], y[0, ..., c]) for c in regions]),
                    "spec": torch.stack([M.specificity(mean_probs[..., c], y[0, ..., c]) for c in regions]),
                }
                loss, aux = model.loss(model(x, y, post_eps=post_eps, prior_eps=prior_eps, generator=generator), y)
        finally:
            model.train(was_training)
        out.update(loss=loss, kl=aux["kl"], recon=aux["recon"], pred_bin=mean_probs > 0.5)
        return out

    def _to_host(self, out: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """Copies of device results into page-locked host memory, issued now,
        and the event that marks them done (None on the CPU)."""
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        if self.device.type != "cuda":
            return host, None
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _brats_eval_split(self, data) -> str:
        """The reference's split never fills 'test', so the quantitative
        evaluation falls back to the validation split where 'test' is empty."""
        if data.num_examples("test") > 0:
            return "test"
        log.info("BraTS test split is empty; evaluating the validation split")
        return "validation"

    def stream_volumes(self, data, split: str, n: int, n_samples: int, salt: int,
                       first_index: int = 0) -> Iterator[tuple]:
        """``eval_volume`` of volumes 0..n-1 of ``split``, each with noise
        index ``first_index + i``, through ``_fetched``: yields (i, host
        results, image, labels, pid) in order."""
        def issued():
            for ii in range(n):
                img, lbl, pid = data.get(ii, split)
                yield self.eval_volume(self._to_device(img[None]), self._to_device(lbl[None]), n_samples, salt,
                                       first_index + ii), (ii, img, lbl, pid)

        for host, (ii, img, lbl, pid) in self._fetched(issued()):
            yield ii, host, img, lbl, pid

    @staticmethod
    def _hd95_row(host: Dict[str, torch.Tensor], lbl: np.ndarray) -> List[float]:
        pred_bin = host["pred_bin"].numpy()
        return [M.hd95(pred_bin[..., c], lbl[..., c]) for c in range(lbl.shape[-1])]

    def validate_brats(self, data) -> Dict[str, float]:
        """The BraTS validation, the twin of the JAX ``validate_brats``: saves
        ``validation_ckpt``, evaluates ``num_validation_images`` volumes with
        ``validation_samples`` samples each, HD95 a region on the host, keeps
        ``best_dice`` and ``best_loss``, writes the aggregates (per-region
        Dice, sensitivity, specificity and HD95, whose mean skips the -1 of
        an empty mask) and returns them."""
        cfg = self.cfg
        t0 = time.time()
        self.save_model("validation_ckpt")
        self._log_memory()
        n_total = data.num_examples("validation")
        n_val = n_total if cfg.num_validation_images == "all" else min(cfg.num_validation_images, n_total)
        rows, hd95_rows = [], []
        for ii, host, img, lbl, _ in self.stream_volumes(data, "validation", n_val, cfg.validation_samples, salt=0):
            hd95_rows.append(self._hd95_row(host, lbl))
            rows.append(host)
            if ii < 2 and self.validation_writer.tensorboard:  # mid-depth slice: image / GT WT / predicted WT
                mid = img.shape[0] // 2
                x_sl = img[mid, ..., 0]
                lo, hi = float(x_sl.min()), float(x_sl.max())
                panel = [(x_sl - lo) / max(hi - lo, 1e-8), lbl[mid, ..., 0],
                         host["pred_bin"][mid, ..., 0].numpy().astype(np.float32)]
                self.validation_writer.image(self.iteration, f"panel_{ii}", np.concatenate(panel, axis=1))
        stacked = {k: np.stack([r[k].numpy() for r in rows]) for k in ("dice", "sens", "spec")}
        hd95 = np.ma.masked_equal(np.asarray(hd95_rows), -1.0)  # -1 where a mask was empty
        agg = {k: float(np.mean([r[k].item() for r in rows])) for k in ("loss", "kl", "recon")}
        agg["dice"] = float(stacked["dice"].mean())
        for c, region in enumerate(BRATS_REGIONS):
            agg[f"dice_{region}"] = float(stacked["dice"][:, c].mean())
        for name, key in (("sensitivity", "sens"), ("specificity", "spec")):
            for c, region in enumerate(BRATS_REGIONS):
                agg[f"{name}_{region}"] = float(stacked[key][:, c].mean())
        for c, region in enumerate(BRATS_REGIONS):
            agg[f"hd95_{region}"] = float(np.ma.filled(hd95[:, c].mean(), -1.0))
        log.info("brats validation @%d: dice WT %.4f TC %.4f ET %.4f sens WT %.4f spec WT %.4f hd95 WT %.2f "
                 "loss %.4f (%.1fs)", self.iteration, agg["dice_wt"], agg["dice_tc"], agg["dice_et"],
                 agg["sensitivity_wt"], agg["specificity_wt"], agg["hd95_wt"], agg["loss"], time.time() - t0)
        if agg["dice"] >= self.best["dice"]:
            self.best["dice"] = agg["dice"]
            self.save_model("best_dice")
        if agg["loss"] <= self.best["loss"]:
            self.best["loss"] = agg["loss"]
            self.save_model("best_loss")
        self.validation_writer.scalars(self.iteration, agg)
        return agg

    def test_brats(self, data, num_repeats: int = 10, num_samples: int = 10, checkpoint: Optional[str] = "best_loss",
                   save_npz: bool = True) -> Dict[str, object]:
        """The quantitative BraTS sweep, the twin of the JAX ``test_brats``:
        restores ``checkpoint``, then ``num_repeats`` passes over the
        evaluation split (``_brats_eval_split``) with ``num_samples`` samples
        a volume. Writes ``brats_test_results.npz`` (``dice``,
        ``sensitivity``, ``specificity`` and ``hd95``, each (R, N, 3)) and
        returns the Dice's mean and standard deviation, the per-region means
        and the seconds it took."""
        self._restore_for_test(checkpoint)
        split = self._brats_eval_split(data)
        n_vols, nreg = data.num_examples(split), self.cfg.n_classes
        dice, sens, spec, hd95 = (np.zeros((num_repeats, n_vols, nreg)) for _ in range(4))
        t0 = time.time()
        for rep in range(num_repeats):
            for ii, host, _, lbl, _ in self.stream_volumes(data, split, n_vols, num_samples, salt=1,
                                                           first_index=rep * n_vols):
                dice[rep, ii], sens[rep, ii], spec[rep, ii] = (host[k].numpy() for k in ("dice", "sens", "spec"))
                hd95[rep, ii] = self._hd95_row(host, lbl)
        hd95_valid = np.ma.masked_equal(hd95, -1.0)
        results = {
            "dice": (float(dice.mean()), float(dice.std())),
            "dice_per_region": dice.mean(axis=(0, 1)).tolist(),
            "sensitivity_per_region": sens.mean(axis=(0, 1)).tolist(),
            "specificity_per_region": spec.mean(axis=(0, 1)).tolist(),
            "hd95_per_region": [float(np.ma.filled(hd95_valid[:, :, c].mean(), -1.0)) for c in range(nreg)],
            "seconds": time.time() - t0,
        }
        log.info("brats test (%s split): dice %.4f±%.4f per-region %s hd95 %s", split, *results["dice"],
                 np.round(results["dice_per_region"], 4), np.round(results["hd95_per_region"], 2))
        if save_npz:
            np.savez(os.path.join(self.log_dir, "brats_test_results.npz"), dice=dice, sensitivity=sens,
                     specificity=spec, hd95=hd95)
        return results

    def export_predictions(self, data, num_samples: int = 10, out_dir: Optional[str] = None,
                           split: Optional[str] = None) -> List[str]:
        """The BraTS prediction export, the twin of the JAX
        ``export_predictions``: each volume's thresholded mean prediction
        becomes a BraTS label map (ET 4, TC without ET 1, WT without TC 2),
        keeps each label's largest connected component, goes back into the
        original geometry where the cache has crop offsets, and is written
        as ``prediction_<pid>.nii.gz`` (uint8) in ``out_dir`` (default
        ``predictions`` in the log directory). The noise is the
        validation's. Returns the paths."""
        from unet_zoo_tpu_torch.data.brats import reassemble_to_original
        from unet_zoo_tpu_torch.utils.nii import save_nii
        from unet_zoo_tpu_torch.utils.postprocess import keep_largest_connected_components

        out_dir = out_dir or os.path.join(self.log_dir, "predictions")
        os.makedirs(out_dir, exist_ok=True)
        split = split or self._brats_eval_split(data)
        paths = []
        for ii, host, _, _, pid in self.stream_volumes(data, split, data.num_examples(split), num_samples, salt=0):
            wt, tc, et = (host["pred_bin"][..., c].numpy() for c in range(3))
            labels = np.zeros(wt.shape, np.uint8)
            labels[wt] = 2
            labels[tc] = 1
            labels[et] = 4
            labels = keep_largest_connected_components(labels)
            offs = data.offsets(ii, split)
            if offs is not None:
                lo, hi, orig_shape = offs
                labels = reassemble_to_original(labels, tuple(orig_shape), tuple(lo), tuple(hi))
            else:
                log.info("no crop offsets in the cache; exporting pid %d on the preprocessed %s grid", pid,
                         labels.shape)
            path = os.path.join(out_dir, f"prediction_{pid}.nii.gz")
            save_nii(path, labels.astype(np.uint8))
            paths.append(path)
        log.info("wrote %d predictions to %s", len(paths), out_dir)
        return paths

    # sample images

    def generate_images(self, data, num_samples: int = 10, out_dir: Optional[str] = None,
                        max_images: Optional[int] = 10, eps: Optional[Sequence] = None) -> str:
        """PNGs of the first ``max_images`` test images (all with None), the
        twin of the JAX ``generate_images``: ``img_{i}.png``, the first
        annotator's ``gt_{i}.png`` and ``sample_{i}_{s}.png``, the argmax of
        each of ``num_samples`` samples. A 3D BraTS experiment writes the
        mid-depth slice of its evaluation split (``_brats_eval_split``): the
        last (flair) channel, the whole-tumour ground truth, and each
        sample's whole-tumour prediction (softmax > 0.5). Each array is
        scaled to 0-255 by its own minimum and maximum (an all-zero mask
        stays zero) and written by ``utils.png``. The z noise of image i
        comes from ``eval_generator(GENERATE_SALT, i)``, or ``eps[i]``
        replaces it (``sample``'s ``eps``). Writes into ``out_dir`` (default
        ``samples`` in the log directory) and returns it."""
        from unet_zoo_tpu_torch.utils.png import write_png

        out_dir = out_dir or os.path.join(self.log_dir, "samples")
        os.makedirs(out_dir, exist_ok=True)

        def to_png(arr, name):
            arr = np.asarray(arr, dtype=np.float32)
            lo, hi = arr.min(), arr.max()
            arr = (arr - lo) / max(hi - lo, 1e-8)
            write_png(os.path.join(out_dir, name), (arr * 255).astype(np.uint8))

        if self._is_brats():
            split = self._brats_eval_split(data)
            images = ((img, lbl) for img, lbl, _ in (data.get(ii, split) for ii in range(data.num_examples(split))))
            n = data.num_examples(split)
        else:
            n = data.test.images.shape[0]
            images = ((np.array(data.test.images[ii], dtype=np.float32)[..., None], data.test.labels[ii])
                      for ii in range(n))
        n = n if max_images is None else min(n, max_images)
        model = self.state.model
        was_training = model.training
        model.eval()
        try:
            for ii, (img, lbl) in zip(range(n), images):
                with torch.inference_mode():
                    logits = self._sample(self._to_device(img[None]), num_samples,
                                          self.eval_generator(GENERATE_SALT, ii), None if eps is None else eps[ii])
                    if self._is_brats():  # the whole tumour's probability
                        preds = (torch.softmax(logits[0].float(), dim=-1)[..., 0] > 0.5).cpu().numpy()
                    else:
                        preds = logits[0].argmax(-1).cpu().numpy()  # (n, *S)
                if self._is_brats():
                    mid = img.shape[0] // 2
                    img, gt, preds = img[mid, ..., -1], lbl[mid, ..., 0], preds[:, mid]
                else:
                    img, gt = img[..., 0], np.asarray(lbl)[..., 0]
                to_png(img, f"img_{ii}.png")
                to_png(gt, f"gt_{ii}.png")
                for s_ in range(num_samples):
                    to_png(preds[s_], f"sample_{ii}_{s_}.png")
        finally:
            model.train(was_training)
        log.info("wrote the sample PNGs of %d images to %s", n, out_dir)
        return out_dir


    # checkpoints and observability

    def save_model(self, savename: str) -> None:
        """The full-state checkpoint ``savename`` in the log directory, and
        ``best_metrics.json``; written by process 0 alone (every process
        holds the same state)."""
        if not self.is_main:
            return
        save_checkpoint(os.path.join(self.log_dir, savename), self.state)
        with open(os.path.join(self.log_dir, "best_metrics.json"), "w") as f:
            json.dump({"iteration": self.iteration, **self.best}, f)

    def restore(self, savename: str) -> None:
        """Full-state resume from ``savename``: the train state, the best
        metrics so far (so the first validation after it cannot overwrite
        an earlier best_* checkpoint), and ``iteration`` realigned on the
        state's step, so ``train`` goes on toward the same total. Every
        process reads the same file, after a barrier that lets process 0
        finish writing it."""
        barrier("restore")
        restore_checkpoint(os.path.join(self.log_dir, savename), self.state)
        best_path = os.path.join(self.log_dir, "best_metrics.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                saved = json.load(f)
            for k in self.best:
                if k in saved:
                    self.best[k] = saved[k]
        self.iteration = self.state.step

    def close(self) -> None:
        """Closes the train and validation metrics streams."""
        for writer in (self.training_writer, self.validation_writer):
            if writer is not None:
                writer.close()

    def _log_memory(self) -> Optional[int]:
        """Peak device memory in bytes (None on the CPU), as the reference
        logs ``torch.cuda.max_memory_allocated`` at each validation."""
        if self.device.type != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated(self.device)
        log.info("device peak memory: %.1f MiB", peak / 2 ** 20)
        return peak
