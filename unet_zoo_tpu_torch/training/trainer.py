"""The train step, the twin of ``unet_zoo_tpu.training.trainer.Trainer``'s
construction and ``_step_fn`` (the U-Net and PHiSeg 2D families, 2D device
augmentation).

One step, all on the device and with no host sync: augmentation (draws from
the state's generator) -> the model in train mode (the U-Net's blocks through
the conv-chain kernel; PHiSeg with the mask, its z noise drawn from the same
generator after the augmentation's, its BatchNorm running statistics updated
in the forward) -> the family's loss -> backward -> the plateau scheduler on
this step's loss -> coupled-L2 Adam at the scheduler's learning rate, in the
JAX step's order. The validate/test/export loop and the CLI are not ported
yet (ROADMAP, queue A items 5-6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from unet_zoo_tpu_torch.data.augment import AugmentParams, sample_augment_params, warp_batch_2d
from unet_zoo_tpu_torch.experiments.config import ExperimentConfig
from unet_zoo_tpu_torch.models.registry import get_model, resolve_device
from unet_zoo_tpu_torch.training.schedule import plateau_init, plateau_update
from unet_zoo_tpu_torch.training.state import TrainState


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
    def __init__(self, cfg: ExperimentConfig, device=None, seed: Optional[int] = None):
        """Builds the model (weights drawn on the CPU from a generator
        seeded from ``seed``, default ``cfg.seed``, then moved to
        ``device``, by default the CUDA card), the optimizer and the train
        state, whose device generator makes every draw of a step.
        Raises where no card is present and ``device`` is not given."""
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.seed if seed is None else seed
        # two seeds split from one, as the JAX trainer splits its root key
        k_params, k_aug = torch.randint(2 ** 62, (2,), generator=torch.Generator().manual_seed(seed)).tolist()
        model = get_model(cfg.model, **cfg.model_kwargs(), device=self.device,
                          generator=torch.Generator().manual_seed(k_params))
        self.state = TrainState(
            model=model,
            optimizer=adam_coupled_l2(model.parameters(), cfg.learning_rate, cfg.weight_decay),
            sched=plateau_init(cfg.learning_rate, self.device),
            generator=torch.Generator(device=self.device).manual_seed(k_aug),
        )

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

    def forward_loss(self, x: torch.Tensor, y: torch.Tensor, z_eps: Optional[List[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The model in train mode (an evaluation may have left it in eval
        mode) and its loss. For PHiSeg ``z_eps`` replaces the posterior's z
        noise, one tensor a latent level."""
        model = self.state.model
        model.train()
        if self.cfg.model == "phiseg":
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
                   z_eps: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One step on images x (B, H, W, C) float and labels y (B, H, W)
        int. ``aug_params`` and ``z_eps`` (PHiSeg) replace the step's own
        draws (tests inject the JAX package's). Returns the loss's aux dict
        as device tensors."""
        x, y = self.augment(x, y, aug_params)
        loss, aux = self.forward_loss(x, y, z_eps)
        self.backward(loss)
        self.update(loss)
        return {k: v.detach() for k, v in aux.items()}
