"""The training harness, the twin of ``unet_zoo_tpu.training.trainer.Trainer``
(the U-Net, ProbUNet and PHiSeg 2D families, 2D device augmentation, one
card).

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
``best_{dice,loss,ged,ncc}``, ``last``).

Evaluation draws its z noise from a device generator seeded from (seed,
step, salt, image index) (``eval_generator``), never from the train
state's generator, as the JAX package derives each image's key with
``fold_in`` and leaves ``state.rng`` alone: a validation changes nothing
of the training run that follows it. Annotator picks come from a numpy
generator seeded as the JAX package seeds it (``_eval_rng``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from unet_zoo_tpu_torch import metrics as M
from unet_zoo_tpu_torch.data.augment import AugmentParams, sample_augment_params, warp_batch_2d
from unet_zoo_tpu_torch.experiments.config import ExperimentConfig, SystemConfig
from unet_zoo_tpu_torch.models.registry import get_model, resolve_device
from unet_zoo_tpu_torch.ops.conv import chain_route
from unet_zoo_tpu_torch.training.schedule import plateau_init, plateau_update
from unet_zoo_tpu_torch.training.state import TrainState, restore_checkpoint, save_checkpoint
from unet_zoo_tpu_torch.utils.summary import MetricsWriter

log = logging.getLogger(__name__)

# the scalar results of one evaluated image, in the order of a row of
# ``Trainer.evaluate_images``; the per-class Dice follows them
EVAL_SCALARS = ("ged", "ncc", "loss", "kl", "recon")


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
                 sys_config: Optional[SystemConfig] = None, log_dir: Optional[str] = None, tensorboard: bool = True):
        """Builds the model (weights drawn on the CPU from a generator
        seeded from ``seed``, default ``cfg.seed``, then moved to
        ``device``, by default the CUDA card), the optimizer and the train
        state, whose device generator makes every draw of a step; creates
        the log directory (default ``log_root/log_dir_name/experiment_name``
        of ``sys_config``) with its train and validation metrics streams,
        and loads ``cfg.pretrained_model`` from it where that file exists.
        Raises where no card is present and ``device`` is not given."""
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sys_config = sys_config or SystemConfig()
        self.log_dir = log_dir or os.path.join(self.sys_config.log_root, cfg.log_dir_name, cfg.experiment_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.seed = cfg.seed if seed is None else seed
        # two seeds split from one, as the JAX trainer splits its root key
        k_params, k_aug = torch.randint(2 ** 62, (2,), generator=torch.Generator().manual_seed(self.seed)).tolist()
        model_kwargs = cfg.model_kwargs()
        model = get_model(cfg.model, **model_kwargs, device=self.device,
                          generator=torch.Generator().manual_seed(k_params))
        # the BN-free conv chains (the U-Net's plain and remat blocks): the
        # hand-written kernel of the compute dtype, or the CPU's plain version
        self.chain_route = chain_route(model_kwargs["dtype"] or torch.float32, self.device)
        log.info("%s: %s, memory mode %s, %s compute on %s; BN-free conv chains run on: %s", cfg.experiment_name,
                 cfg.model, cfg.effective_reversible_mode, cfg.dtype, self.device, self.chain_route)
        self.state = TrainState(
            model=model,
            optimizer=adam_coupled_l2(model.parameters(), cfg.learning_rate, cfg.weight_decay),
            sched=plateau_init(cfg.learning_rate, self.device),
            generator=torch.Generator(device=self.device).manual_seed(k_aug),
        )
        self.iteration = 0
        self.best = {"dice": -1.0, "loss": math.inf, "ged": math.inf, "ncc": -1.0}
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

    def augment(self, x: torch.Tensor, y: torch.Tensor,
                aug_params: Optional[AugmentParams] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Move the batch to the device and warp it with ``aug_params``, or
        with draws from the state's generator."""
        x, y = x.to(self.device), y.to(self.device)
        opts = self.cfg.augmentation_options
        if opts is None:
            return x, y
        if aug_params is None:
            aug_params = sample_augment_params(self.state.generator, x.shape[0], tuple(x.shape[1:3]),
                                               opts, self.device)
        return warp_batch_2d(x, y, aug_params, opts)

    def forward_loss(self, x: torch.Tensor, y: torch.Tensor, z_eps=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The model in train mode (an evaluation may have left it in eval
        mode) and its loss. ``z_eps`` replaces the posterior's z noise: for
        PHiSeg one tensor a latent level, for ProbUNet one (B, latent_dim)
        tensor."""
        model = self.state.model
        model.train()
        if self.cfg.model in ("phiseg", "prob_unet"):
            return model.loss(model(x, y, post_eps=z_eps, generator=self.state.generator), y)
        return model.loss(model(x), y)

    def backward(self, loss: torch.Tensor) -> None:
        self.state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    def update(self, loss: torch.Tensor) -> None:
        """The plateau scheduler on this step's loss, then Adam at its rate."""
        cfg, state = self.cfg, self.state
        state.sched = plateau_update(state.sched, loss, factor=cfg.lr_plateau_factor,
                                     patience=cfg.lr_plateau_patience, min_lr=cfg.min_lr)
        for group in state.optimizer.param_groups:
            group["lr"].copy_(state.sched.lr)
        state.optimizer.step()
        state.step += 1

    def train_step(self, x: torch.Tensor, y: torch.Tensor, aug_params: Optional[AugmentParams] = None,
                   z_eps=None) -> Dict[str, torch.Tensor]:
        """One step on images x (B, H, W, C) float and labels y (B, H, W)
        int. ``aug_params`` and ``z_eps`` (ProbUNet, PHiSeg) replace the step's own
        draws (tests inject the JAX package's). Returns the loss's aux dict
        as device tensors."""
        x, y = self.augment(x, y, aug_params)
        loss, aux = self.forward_loss(x, y, z_eps)
        self.backward(loss)
        self.update(loss)
        return {k: v.detach() for k, v in aux.items()}

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
        ``logging_frequency``; logging is the loop's only host sync. Returns
        the last step's aux dict (device tensors), or None if there was
        nothing to do."""
        cfg = self.cfg
        n_iter = iterations if iterations is not None else cfg.iterations
        start = self.state.step
        if start >= n_iter:
            log.info("state already at step %d >= %d; nothing to do", start, n_iter)
            return None
        log.info("starting training: filters=%s batch=%d", cfg.filter_channels, cfg.batch_size)
        last_aux = None
        for self.iteration in range(start + 1, n_iter + 1):
            x, y = data.train.next_batch(cfg.batch_size)
            last_aux = self.train_step(self._to_device(x), self._to_device(y))
            if validate and self.iteration % cfg.validation_frequency == 0:
                self.validate(data)
            if self.iteration % cfg.logging_frequency == 0:
                values = {k: float(last_aux[k]) for k in ("loss", "kl", "recon")}
                values["lr"] = float(self.state.sched.lr)
                log.info("iteration %d loss %.5f", self.iteration, values["loss"])
                self.training_writer.scalars(self.iteration, values)
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
        PHiSeg: (posterior, prior) lists) replace it. Makes no host sync;
        returns device tensors ``ged``, ``ncc``, ``dice``, ``loss``, ``kl``,
        ``recon``, ``mean_pred`` and ``sample0``."""
        model = self.state.model
        family = self.cfg.model
        stochastic = family in ("phiseg", "prob_unet")
        generator = self.eval_generator(salt, index) if stochastic else None
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = (model.sample(x, n_samples, eps=eps, generator=generator) if stochastic
                          else model.sample(x, n_samples))
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

    def _upload(self, split, n: int) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
        """The first ``n`` images and labels of ``split`` (``images`` (N,
        *S), ``labels`` (N, *S, A)) on the device, once: (host images,
        images (n, *S, 1) float32, labels (n, A, *S) int64)."""
        images = np.asarray(split.images[:n], dtype=np.float32)
        labels = np.moveaxis(np.asarray(split.labels[:n]), -1, 1).astype(np.int64)
        return images, torch.from_numpy(images[..., None]).to(self.device), torch.from_numpy(labels).to(self.device)

    def evaluate_images(self, images: torch.Tensor, labels: torch.Tensor, chosen: List[int], n_samples: int,
                        n_loss: int, salt: int, first_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``eval_image`` of every uploaded image against annotator
        ``chosen[i]``, all issued before anything is fetched: no host sync.
        Returns device tensors: (n, 5 + C) float32 rows (``EVAL_SCALARS``,
        then the per-class Dice) and the (n, 2, *S) maps mean_pred and
        sample0."""
        rows, maps = [], []
        with torch.inference_mode():
            for ii, a in enumerate(chosen):
                out = self.eval_image(images[ii:ii + 1], labels[ii], labels[ii, a:a + 1], n_samples, n_loss, salt,
                                      first_index + ii)
                rows.append(torch.cat([torch.stack([out[k].float() for k in EVAL_SCALARS]), out["dice"]]))
                maps.append(torch.stack([out["mean_pred"], out["sample0"]]))
            return torch.stack(rows), torch.stack(maps)

    def validate(self, data) -> Dict[str, float]:
        """Saves ``validation_ckpt``, evaluates ``num_validation_images``
        validation images with ``validation_samples`` samples (and as many
        loss repeats), fetches the results once, keeps the best-per-metric
        checkpoints, writes the aggregates and returns them."""
        cfg = self.cfg
        t0 = time.time()
        self.save_model("validation_ckpt")
        self._log_memory()
        n_total = data.validation.images.shape[0]
        n_val = n_total if cfg.num_validation_images == "all" else min(cfg.num_validation_images, n_total)
        val_rng, annotators = self._eval_rng(), self._annotators()
        chosen = [int(val_rng.choice(annotators)) for _ in range(n_val)]
        host_images, images, labels = self._upload(data.validation, n_val)
        rows, maps = self.evaluate_images(images, labels, chosen, cfg.validation_samples, cfg.validation_samples,
                                          salt=0)
        rows = rows.cpu().numpy()

        if self.validation_writer.tensorboard:
            # panels: input / the chosen annotator / mean prediction / one sample
            nlab = max(cfg.n_classes - 1, 1)
            panels = maps[:4].cpu().numpy()
            for ii in range(len(panels)):
                x = host_images[ii]
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
        it took."""
        cfg = self.cfg
        if checkpoint is not None:
            path = os.path.join(self.log_dir, checkpoint)
            if not os.path.exists(path):
                raise FileNotFoundError(f"checkpoint '{checkpoint}' not found in {self.log_dir}")
            restore_checkpoint(path, self.state)
        n_images = data.test.images.shape[0]
        test_rng, annotators = self._eval_rng(salt=1), self._annotators()
        ged_mat = np.zeros((num_repeats, n_images))
        ncc_mat = np.zeros((num_repeats, n_images))
        dice_mat = np.zeros((num_repeats, n_images, cfg.n_classes))
        t0 = time.time()
        _, images, labels = self._upload(data.test, n_images)
        for rep in range(num_repeats):
            chosen = [int(test_rng.choice(annotators)) for _ in range(n_images)]
            rows, _ = self.evaluate_images(images, labels, chosen, num_samples, 1, salt=1,
                                           first_index=rep * n_images)
            rows = rows.cpu().numpy()
            ged_mat[rep], ncc_mat[rep], dice_mat[rep] = rows[:, 0], rows[:, 1], rows[:, len(EVAL_SCALARS):]
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

    # checkpoints and observability

    def save_model(self, savename: str) -> None:
        """The full-state checkpoint ``savename`` in the log directory, and
        ``best_metrics.json``."""
        save_checkpoint(os.path.join(self.log_dir, savename), self.state)
        with open(os.path.join(self.log_dir, "best_metrics.json"), "w") as f:
            json.dump({"iteration": self.iteration, **self.best}, f)

    def restore(self, savename: str) -> None:
        """Full-state resume from ``savename``: the train state, the best
        metrics so far (so the first validation after it cannot overwrite
        an earlier best_* checkpoint), and ``iteration`` realigned on the
        state's step, so ``train`` goes on toward the same total."""
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
        self.training_writer.close()
        self.validation_writer.close()

    def _log_memory(self) -> Optional[int]:
        """Peak device memory in bytes (None on the CPU), as the reference
        logs ``torch.cuda.max_memory_allocated`` at each validation."""
        if self.device.type != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated(self.device)
        log.info("device peak memory: %.1f MiB", peak / 2 ** 20)
        return peak
