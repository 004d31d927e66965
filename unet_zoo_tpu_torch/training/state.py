"""Train state and checkpoint I/O, the twin of ``unet_zoo_tpu.training.state``.

The checkpoint is the complete training state, as in the JAX package: the
model's ``state_dict`` (BatchNorm's running statistics included), the
optimizer's state (Adam moments, step counts and learning rate), the
plateau scheduler's state, the step counter and the state of the generator
of the step's draws (augmentation, then PHiSeg's z noise). Restoring it and stepping on gives the same
result as never having stopped.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from unet_zoo_tpu_torch.training.schedule import PlateauState


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    sched: PlateauState
    generator: torch.Generator  # the step's draws: augmentation, then z noise
    step: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "sched": self.sched._asdict(),
            "generator": self.generator.get_state(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        device = self.sched.lr.device
        self.sched = PlateauState(**{k: v.to(device) for k, v in state["sched"].items()})
        self.generator.set_state(state["generator"].cpu())  # a generator's state is a CPU byte tensor
        self.step = int(state["step"])


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the full state to the file ``path``, atomically."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the file ``path`` into ``state`` (built with the same model and
    optimizer layout) in place, onto the device of its scheduler, and return
    it."""
    state.load_state_dict(torch.load(path, map_location=state.sched.lr.device, weights_only=True))
    return state
