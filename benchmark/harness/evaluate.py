"""The evaluation cell: a closed loop of single test images through
``Trainer.stream_images``, each call one image of the seeded test split
taken in turn with ``Trainer.test``'s arguments (``samples`` samples,
``n_loss`` loss repeats, ``salt``) and its maps, returning once the image's
results are on the host; the next call follows.

Each call's z noise is drawn by the benchmark from the seed and the call's
index and given to ``Trainer.eval_image`` (its ``eps`` and ``loss_eps``), so
the reference decodes the same noise. The untrained weights drawn from the
seed serve: no training runs first. Once the window has closed and the
program is freed, the reference evaluates a sample of the window's calls,
drawn from the seed.
"""

from __future__ import annotations

import contextlib
import sys
import time
import types
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import check, common, inputs, spec
from benchmark.reference import metrics as ref_metrics
from benchmark.reference import ops as ref_ops

# answers altered where they are produced: NCC shifted by ALTERED_NCC, GED
# over all samples but the last, Dice against the next grader's mask
FAULTS = ("altered_ncc", "altered_ged", "altered_dice")
ALTERED_NCC = 1e-3


class EvalRun:
    def __init__(self, c: spec.Cell, seed: int, device, log_dir: str, overrides: Optional[dict] = None,
                 fault: Optional[str] = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault '{fault}'; known: {FAULTS}")
        self.c, self.w, self.seed, self.device = c, c.workload, seed, torch.device(device)
        self.log_dir, self.fault = log_dir, fault
        self.cfg = spec.experiment(c, overrides)
        self.model = common.reference_model(c, overrides)
        self.noise = self.model.image_noise_shapes(self.w["samples"], self.w["n_loss"])
        self.calls = []  # (index, image, grader, host rows, host maps) of the window's calls
        self.index = 0

    def setup(self) -> None:
        from unet_zoo_tpu_torch.data.lidc import LIDCData
        from unet_zoo_tpu_torch.training import Trainer

        m, graders, clock = self.model, self.c.config["data"]["graders"], common.Clock(self.device)
        arrays = inputs.lidc_arrays(self.w["data"], m.image_size[0], graders, self.seed, self.device)
        self.images, self.labels = arrays["test"]["images"], arrays["test"]["labels"]
        self.split = LIDCData(arrays, seed=self.seed).test
        self.picks = np.random.default_rng(inputs.mix(self.seed, inputs.PICKS))
        clock.lap("data")
        self.trainer = Trainer(self.cfg, device=self.device, seed=self.seed, log_dir=self.log_dir, tensorboard=False)
        self.p0, self.bufs0 = inputs.weights(m.specs(), self.seed, self.device)
        self._running_statistics()
        inputs.load_into(self.trainer.state.model, self.p0, self.bufs0)
        self._give_draws()
        clock.lap("trainer and weights")
        for _ in range(self.w["warmup_images"]):
            self.call()
        clock.lap("warm-up images")
        self.phases = clock.laps

    def _running_statistics(self) -> None:
        """BatchNorm's running statistics, which eval mode normalises with,
        set to those of one train-mode pass of the reference over the first
        ``statistics_images`` test images (each with its first grader's
        mask, zero z noise): activations then keep a trained net's scale
        through the depth, where the drawn 0 and 1 would let them fade
        and every sample decode alike."""
        n = self.w["statistics_images"]
        x = torch.from_numpy(self.images[:n].astype(np.float32)).to(self.device)[:, None]
        mask = torch.from_numpy(self.labels[:n, ..., 0].astype(np.int64)).to(self.device)
        with torch.no_grad(), ref_ops.one_batch_statistics(), common.precision(False):
            self.model.step_loss(self.p0, self.bufs0, x, mask, train=True)

    def _draws(self, index: int, device=None) -> dict:
        return inputs.image_draws(self.seed, index, self.noise, device or self.device)

    def _give_draws(self) -> None:
        tr = self.trainer
        eval_image = tr.eval_image

        def given_draws(x, y_all, y_chosen, n_samples, n_loss=1, salt=0, index=0, eps=None, loss_eps=None):
            d = self._draws(index)
            out = eval_image(x, y_all, y_chosen, n_samples, n_loss, salt, index, eps=d["eps"], loss_eps=d["loss_eps"])
            if self.fault == "altered_ncc":
                out["ncc"] = out["ncc"] + ALTERED_NCC
            return out

        tr.eval_image = given_draws
        if self.fault in ("altered_ged", "altered_dice"):
            self._alter_metrics()

    def _alter_metrics(self) -> None:
        """The port's ``image_metrics``, as ``eval_image`` finds it, with GED
        or Dice computed wrong."""
        from unet_zoo_tpu_torch import metrics as M
        from unet_zoo_tpu_torch.training import trainer as module

        image_metrics, C = module.image_metrics, self.model.C

        def altered(logits, y_all, y_chosen):
            out = image_metrics(logits, y_all, y_chosen)
            if self.fault == "altered_ged":
                labels = logits[:-1].float().argmax(-1)
                out["ged"] = M.generalised_energy_distance(labels, y_all, nlabels=C - 1, label_range=range(1, C))
            else:
                a = int(((y_all == y_chosen).flatten(1).all(1)).int().argmax())
                other = y_all[(a + 1) % y_all.shape[0]]
                out["dice"] = M.dice_per_label(out["mean_pred"].long(), other, C)
            return out

        module.image_metrics = altered
        self._restore_metrics = lambda: setattr(module, "image_metrics", image_metrics)

    def call(self):
        """One image, evaluated and fetched: (index, image, grader, host results)."""
        j = self.index
        self.index += 1
        i = j % self.images.shape[0]
        a = int(self.picks.integers(self.labels.shape[-1]))
        view = types.SimpleNamespace(images=self.split.images[i:i + 1], labels=self.split.labels[i:i + 1])
        host = None
        for host, _ in self.trainer.stream_images(view, [a], self.w["samples"], self.w["n_loss"], self.w["salt"],
                                                  first_index=j, n_maps=1):
            pass
        return j, i, a, host

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        latency = []
        while True:
            t = time.perf_counter()
            self.calls.append(self.call())
            latency.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                break
        took = time.perf_counter() - t0
        print("latency ms over %d images: min %.3f, median %.3f, p90 %.3f, max %.3f" % (
            len(latency), *(float(np.percentile(latency, q)) * 1e3 for q in (0, 50, 90, 100))), file=sys.stderr)
        rows = torch.cat([host["rows"] for _, _, _, host in self.calls])
        failed = int((~torch.isfinite(rows).all(1)).sum())
        return {"metrics": {"eval_images_per_s": len(latency) / took,
                            "eval_image_ms_p90": float(np.percentile(latency, 90)) * 1e3},
                "attempted": len(latency), "failed": failed}

    def traced(self) -> dict:
        """``trace_images`` calls with the device's activity alone traced
        (busy and idle time, launches, the longest operations), then as many
        with the host's ops too, each call under a span."""
        w = self.w

        def images(span=False):
            for _ in range(w["trace_images"]):
                with torch.profiler.record_function("bench.image") if span else contextlib.nullcontext():
                    self.calls.append(self.call())

        _, light = common.profiled(self.device, images, host_ops=False)
        _, t = common.profiled(self.device, lambda: images(span=True))
        return {"trace": t, "light": light, "units": w["trace_images"], "model": self.model}

    # the comparison

    def program_outputs(self) -> dict:
        """The results of a sample of the window's calls, drawn from the seed."""
        rng = np.random.default_rng(inputs.mix(self.seed, inputs.PICKS, 1))
        n = min(self.w["check_images"], len(self.calls))
        picked = sorted(rng.choice(len(self.calls), n, replace=False).tolist())
        C = self.model.C
        out = []
        for k in picked:
            j, i, a, host = self.calls[k]
            row = host["rows"][0].double()
            out.append({"call": (j, i, a), "ged": float(row[0]), "ncc": float(row[1]), "loss": float(row[2]),
                        "kl": float(row[3]), "recon": float(row[4]), "dice": row[5:5 + C],
                        "mean_pred": host["maps"][0, 0].long(), "sample0": host["maps"][0, 1].long()})
        return {"images": out}

    def free(self) -> None:
        getattr(self, "_restore_metrics", lambda: None)()
        del self.trainer, self.split
        common.release(self.device)

    def reference(self, program: dict, tf32: bool = False) -> dict:
        """Each sampled call again: the samples decoded from the same noise,
        the metrics, the eval-mode loss; in TF32 for the control."""
        m, out = self.model, []
        with common.precision(tf32), torch.no_grad():
            for got in program["images"]:
                j, i, a = got["call"]
                d = self._draws(j)
                x = torch.from_numpy(self.images[i].astype(np.float32)).to(self.device)[None, None]
                gts = torch.from_numpy(np.moveaxis(self.labels[i], -1, 0).astype(np.int64)).to(self.device)
                logits = m.sample(self.p0, self.bufs0, x, self.w["samples"], m.to_reference(d["eps"]))
                r = ref_metrics.evaluate(logits, gts, gts[a])
                # the Dice of the program's own mean prediction: read only to judge the program's Dice
                dice_of_map = ref_metrics.dice(got["mean_pred"].to(self.device), gts[a], m.C).cpu()
                n_loss = self.w["n_loss"]
                terms = m.step_loss(self.p0, self.bufs0, x.expand(n_loss, -1, -1, -1), gts[a].expand(n_loss, -1, -1),
                                    z_eps=m.to_reference(d["loss_eps"]), train=False)
                out.append({"call": got["call"], "ged": float(r["ged"]), "ncc": float(r["ncc"]),
                            "dice": r["dice"].cpu(), "mean_pred": r["mean_pred"].cpu(), "sample0": r["sample0"].cpu(),
                            "dice_of_map": dice_of_map,
                            **{k: float(v) for k, v in terms.items()}})
        return {"images": out}

    def readings(self, got: dict, want: dict) -> Dict[str, float]:
        """Over the sampled images, the largest gap of each answer: GED, NCC,
        Dice, the Dice against that of the program's own mean prediction
        (``dice_of_map``), the eval-mode loss terms (relative), and the
        pixels of the mean prediction and the first sample that differ."""
        r = {"ged": 0.0, "ncc": 0.0, "dice": 0.0, "dice_of_map": 0.0, "loss": 0.0, "map_pixels": 0.0}
        for g, w in zip(got["images"], want["images"]):
            r["ged"] = max(r["ged"], _gap(g["ged"], w["ged"]))
            r["ncc"] = max(r["ncc"], _gap(g["ncc"], w["ncc"]))
            dice = g["dice"].cpu().double()
            r["dice"] = max(r["dice"], _gap(0.0, float((dice - w["dice"].double()).abs().max())))
            r["dice_of_map"] = max(r["dice_of_map"], _gap(0.0, float((dice - w["dice_of_map"]).abs().max())))
            r["loss"] = max([r["loss"]] + [check.rel(g[k], w[k], 1e-6) for k in ("loss", "kl", "recon")])
            for k in ("mean_pred", "sample0"):
                r["map_pixels"] = max(r["map_pixels"], float((g[k].cpu() != w[k]).sum()))
        return r


def _gap(a: float, b: float) -> float:
    return abs(a - b) if np.isfinite(a) and np.isfinite(b) else float("inf")
