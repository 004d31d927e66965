"""The train cells: ``Trainer.train`` on the cell's registered experiment,
closed loop, validation off.

Set-up builds the data and the ``Trainer`` with the weights drawn from the
seed, keeps a copy of that train state, and warms up: ``check_steps`` steps
with their draws given (augmentation and z noise), then ``warmup_steps``
steps that draw their own. It then puts the kept state back (the public
``TrainState.load_state_dict``, as a resume does), so the window starts
from the seed's weights and a fresh optimizer. The window's first
``check_steps`` steps are the compared ones: its own call
(``Trainer.train``, the batches from ``LIDCData``) with each step's draws
given, recording what the step received, the augmented batch, each loss,
the optimizer's first moments after its first step and the parameters after
the last; then ``Trainer.train`` chunk by chunk until ``--seconds`` are
spent. Once the window has closed and the program is freed, the reference
follows the recorded steps from the same weights, batches and draws.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import check, common, inputs, spec
from benchmark.reference import augment as ref_augment
from benchmark.reference import optim as ref_optim

FAULTS = ("unchanged", "half_batch")


class TrainRun:
    def __init__(self, c: spec.Cell, seed: int, device, log_dir: str, overrides: Optional[dict] = None,
                 fault: Optional[str] = None):
        self.c, self.w, self.seed, self.device = c, c.workload, seed, torch.device(device)
        self.log_dir, self.fault = log_dir, fault
        self.cfg = spec.experiment(c, overrides)
        self.model = common.reference_model(c, overrides)
        self.batch = self.cfg.batch_size
        self.opt = c.config["optimizer"]

    # set-up

    def setup(self) -> None:
        from unet_zoo_tpu_torch.data.lidc import LIDCData
        from unet_zoo_tpu_torch.training import Trainer

        w, m, clock = self.w, self.model, common.Clock(self.device)
        arrays = inputs.lidc_arrays(w["data"], m.image_size[0], self.c.config["data"]["graders"], self.seed,
                                    self.device)
        self.images, self.labels = arrays["train"]["images"], arrays["train"]["labels"]
        self.data = LIDCData(arrays, seed=self.seed)
        clock.lap("data")
        self.trainer = Trainer(self.cfg, device=self.device, seed=self.seed, log_dir=self.log_dir, tensorboard=False)
        self.p0, self.bufs0 = inputs.weights(m.specs(), self.seed, self.device)
        inputs.load_into(self.trainer.state.model, self.p0, self.bufs0)
        aug = self.c.config["experiment"]["augmentation_options"]
        self.draws = [inputs.step_draws(self.seed, k, self.batch, m.image_size, aug, m.noise_shapes(self.batch),
                                        self.device) for k in range(w["check_steps"])]
        clock.lap("trainer and weights")
        self._plant()
        tr = self.trainer
        start = _cloned(tr.state.state_dict())
        self.check_steps()  # the given draws' path, warmed up; what it records is dropped
        tr.train(self.data, iterations=tr.state.step + w["warmup_steps"], validate=False)
        tr.state.load_state_dict(start)
        clock.lap("warm-up steps")
        self.phases = clock.laps

    def _plant(self) -> None:
        """A fault under the timed path, for the tests and the readings of
        the faults: the state left unchanged by each step, or half of the
        batch left out and the mean taken over the rest."""
        tr = self.trainer
        if self.fault == "unchanged":
            tr._update = lambda loss: setattr(tr.state, "step", tr.state.step + 1)
        elif self.fault == "half_batch":
            forward_loss = tr.forward_loss
            tr.forward_loss = lambda x, y, z_eps=None: forward_loss(x[: x.shape[0] // 2], y[: y.shape[0] // 2],
                                                                  z_eps)
        elif self.fault is not None:
            raise ValueError(f"unknown fault '{self.fault}'; known: {FAULTS}")

    def _aug_params(self, d: dict):
        from unet_zoo_tpu_torch.data.augment import AugmentParams

        field = torch.zeros((self.batch, 2, 3, 3), device=self.device)
        return AugmentParams(d["gate"], d["angle"], d["r"], d["off_r"], d["off_c"], d["flip_lr"], d["flip_ud"], field)

    def check_steps(self) -> None:
        """``check_steps`` steps through ``Trainer.train``, each with its
        draws given, recording what it received and produced."""
        tr = self.trainer
        step, augment = tr.train_step, tr.augment
        draws = iter(self.draws)
        self.fed, self.augmented, self.losses = [], [], []

        def given_draws(x, y):
            d = next(draws)
            self.fed.append((x, y))
            return step(x, y, aug_params=self._aug_params(d), z_eps=d.get("z_eps"))

        def recorded(x, y, aug_params=None):
            out = augment(x, y, aug_params)
            self.augmented.append(out)
            return out

        tr.train_step, tr.augment = given_draws, recorded
        try:
            for k in range(1, self.w["check_steps"] + 1):
                self.losses.append(tr.train(self.data, iterations=k, validate=False)["loss"])
                if k == 1:  # the gradient as Adam took it: its first moment over (1 - beta1)
                    names = {p: n for n, p in tr.state.model.named_parameters()}
                    self.g1 = {names[p]: s["exp_avg"] / (1 - self.opt["betas"][0])
                               for p, s in tr.state.optimizer.state.items() if "exp_avg" in s}
            self.p_end = {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}
        finally:
            del tr.train_step, tr.augment

    # the window

    def window(self, seconds: float, device_time: bool = False) -> dict:
        """The compared steps, then chunks of ``chunk_steps`` until
        ``seconds`` are spent, all timed. With ``device_time`` the whole
        window runs under a trace of the device's activity alone, and
        ``step_device_ms`` is the device's busy time over it a step (on the
        CPU, the window's own time a step)."""
        return self._timed(seconds, compared=True, device_time=device_time)

    def rate_window(self, seconds: float) -> dict:
        """Chunks of ``chunk_steps`` until ``seconds`` are spent, timed as
        ``window`` times them: the rate of a traced run, after its traced
        steps (the compared steps are its own)."""
        return self._timed(seconds, compared=False, device_time=False)

    def _timed(self, seconds: float, compared: bool, device_time: bool) -> dict:
        tr, chunk = self.trainer, self.w["chunk_steps"]
        common.sync(self.device)
        with common.device_busy(self.device, device_time) as busy:
            t0 = time.perf_counter()
            if compared:
                self.check_steps()
            ends = []
            while True:
                ends.append(tr.train(self.data, iterations=tr.state.step + chunk, validate=False)["loss"])
                if time.perf_counter() - t0 >= seconds:
                    break
            common.sync(self.device)
            took = time.perf_counter() - t0
        steps = (self.w["check_steps"] if compared else 0) + chunk * len(ends)
        failed = int((~torch.isfinite(torch.stack(ends))).sum()) * chunk
        if compared:
            failed += sum(not torch.isfinite(v) for v in self.losses)
        metrics = {"train_images_per_s": steps * self.batch / took}
        if device_time:
            metrics["step_device_ms"] = (took if busy["busy_s"] is None else busy["busy_s"]) / steps * 1e3
        return {"metrics": metrics, "attempted": steps, "failed": failed}

    def traced(self) -> dict:
        """The per-layer readings, after the compared steps: ``trace_steps``
        steps of ``Trainer.train`` with the device's activity alone traced
        (busy and idle time, launches, the longest operations), then as
        many phase by phase, each under its span, with the host's ops too."""
        from unet_zoo_tpu_torch.parallel import space_sharding

        tr, w, rf = self.trainer, self.w, torch.profiler.record_function
        self.check_steps()
        _, light = common.profiled(
            self.device, lambda: tr.train(self.data, iterations=tr.state.step + w["trace_steps"], validate=False),
            host_ops=False)
        next_batch = []

        def steps():
            for _ in range(w["trace_steps"]):
                with rf("bench.next_batch"):
                    t0 = time.perf_counter()
                    xb, yb = self.data.train.next_batch(self.batch)
                    next_batch.append((time.perf_counter() - t0) * 1e3)
                with rf("bench.upload"):
                    x, y = common.upload(xb, self.device), common.upload(yb, self.device)
                with rf("bench.step"):
                    with space_sharding(tr.mesh):
                        with rf("bench.augment"):
                            xa, ya = tr.augment(x, y)
                        with rf("bench.forward_loss"):
                            loss, _ = tr.forward_loss(xa, ya)
                    with rf("bench.backward"):
                        tr.backward(loss)
                    with rf("bench.update"):
                        tr.update(loss)

        _, tr_ = common.profiled(self.device, steps)
        return {"trace": tr_, "light": light, "units": w["trace_steps"],
                "next_batch_ms": statistics.median(next_batch), "model": self.model, "batch": self.batch}

    # the comparison

    def program_outputs(self) -> dict:
        """What the program produced in the recorded steps, gathered before
        it is freed."""
        index = check.row_index(self.images)
        rows = [check.identify_rows(x.cpu().numpy(), y.cpu().numpy(), self.images, self.labels, index)
                for x, y in self.fed]
        return {"rows": rows, "fed": self.fed, "augmented": self.augmented,
                "losses": [float(v) for v in self.losses], "g1": check.norms(self.g1),
                "change": check.norms({k: self.p_end[k] - self.p0[k] for k in self.p_end})}

    def free(self) -> None:
        del self.trainer, self.data
        common.release(self.device)

    def reference(self, program: dict, tf32: bool = False) -> dict:
        """The reference's steps from the drawn weights, on the batches the
        program was fed (from the benchmark's own arrays where each row was
        identified) with the same draws; in TF32 for the control."""
        p = {k: v.clone().requires_grad_(True) for k, v in self.p0.items()}
        bufs = {k: v.clone() for k, v in self.bufs0.items()}
        opt = ref_optim.Adam(p, self.opt["learning_rate"], self.opt["weight_decay"], *self.opt["betas"])
        out = {"augmented": [], "losses": []}
        with common.precision(tf32):
            for k, d in enumerate(self.draws):
                x, y = self._batch(program, k)
                xa, ya = ref_augment.warp(x, y, d, self.model.C)
                out["augmented"].append((xa, ya))
                z = self.model.to_reference(d["z_eps"]) if "z_eps" in d else None
                terms = self.model.step_loss(p, bufs, xa.permute(0, 3, 1, 2), ya, z_eps=z, train=True)
                grads = torch.autograd.grad(terms["loss"], list(p.values()), allow_unused=True)
                grads = {n: g if g is not None else torch.zeros_like(p[n]) for n, g in zip(p, grads)}
                loss = float(terms["loss"].detach())
                taken = opt.step(p, grads, loss)
                out["losses"].append(loss)
                if k == 0:
                    out["g1"], out["raw1"] = check.norms(taken), check.norms(grads)
        out["change"] = check.norms({k: p[k].detach() - self.p0[k] for k in p})
        return out

    def _batch(self, program: dict, k: int):
        x, y = program["fed"][k]
        rows = program["rows"][k]
        if any(r is None for r in rows):
            return x.float(), y
        idx = [r[0] for r in rows]
        xs = torch.from_numpy(self.images[idx].astype(np.float32))[..., None]
        ys = torch.from_numpy(np.stack([self.labels[i, ..., a] for i, a in rows]).astype(np.int64))
        return xs.to(self.device), ys.to(self.device)

    def readings(self, got: dict, want: dict) -> Dict[str, float]:
        """The numbers compared: fed rows that are no distinct image of the
        split with a grader's mask; the augmented batch; each step's loss;
        the first gradient and the parameters' change, by their worst leaf."""
        r = {}
        if "rows" in got:
            seen = [row[0] for rows in got["rows"] for row in rows if row is not None]
            missing = sum(row is None for rows in got["rows"] for row in rows)
            r["batch_rows"] = float(missing + len(seen) - len(set(seen)))
        img, lbl = 0.0, 0.0
        for (xa, ya), (xb, yb) in zip(got["augmented"], want["augmented"]):
            img = max(img, float((xa.float() - xb.float()).abs().max()))
            lbl = max(lbl, float((ya.long() != yb.long()).sum()))
        r["aug_image"], r["aug_label_pixels"] = img, lbl
        for k, (a, b) in enumerate(zip(got["losses"], want["losses"])):
            r[f"loss_step{k + 1}"] = check.rel(a, b)
        r["grad1_leaf"] = check.worst_leaf(got["g1"], want["g1"])
        r["change_leaf"] = check.worst_leaf(got["change"], want["change"], check.moved_leaves(want["raw1"]))
        return r


def _cloned(state):
    """A copy of a state dict, its tensors cloned."""
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    if isinstance(state, dict):
        return {k: _cloned(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cloned(v) for v in state)
    return state
