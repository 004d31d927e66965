"""The files of a cell, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``workloads/<cell>.json`` and, for each per-layer
metric, ``metrics/<name>.py``; and the port's experiment they describe."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict  # BENCHMARK.json
    entry: dict  # the cell's entry of ``workloads``
    config: dict  # configs/<config>.json
    workload: dict  # workloads/<cell>.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, section: str) -> list:
        """The cell's metrics of ``section`` ("end_to_end" or "per_layer")."""
        return [m for m in self.bench[section] if "workloads" not in m or self.name in m["workloads"]]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload '{name}'; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(name, bench, entry, load_json(os.path.join(ROOT, conf["file"])),
                load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json")))


def reader_module(metric: str):
    """The module ``metrics/<metric>.py``: its ``read(ctx)``, and ``WINDOW``
    where it reads the timed window that a traced run then adds."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    return reader_module(metric).read


def experiment(c: Cell, overrides: Optional[Dict] = None):
    """The port's registered experiment of the cell, checked against the
    configuration file: every key of its ``experiment`` block must equal the
    registry's field, so the file states what runs. ``overrides`` (tests
    only) replace fields after the check."""
    from unet_zoo_tpu_torch.data.augment import AugmentOptions
    from unet_zoo_tpu_torch.experiments import get_experiment

    cfg = get_experiment(c.workload["experiment"])
    want = dict(c.config["experiment"])
    aug = want.pop("augmentation_options")
    if cfg.augmentation_options != AugmentOptions(**aug):
        raise ValueError(f"{c.name}: the registry's augmentation {cfg.augmentation_options} is not the "
                         f"configuration's {aug}")
    for key, value in want.items():
        have = getattr(cfg, key)
        if (list(have) if isinstance(have, tuple) else have) != value:
            raise ValueError(f"{c.name}: the registry's {key} = {have!r} is not the configuration's {value!r}")
    if cfg.batch_size != c.workload["batch_size"]:
        raise ValueError(f"{c.name}: experiment {c.workload['experiment']} has batch {cfg.batch_size}, the cell "
                         f"{c.workload['batch_size']}")
    return dataclasses.replace(cfg, **(overrides or {}))
