"""What the runs load: importing ``run.py`` and driving a cell's set-up
leaves no module of the JAX side in ``sys.modules`` (top-level names,
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark.harness import spec

SETUP = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
import benchmark.run as run
from benchmark import tiny
from benchmark.harness.{module} import {cls}
c, overrides = tiny.cell({cell!r})
with tempfile.TemporaryDirectory() as d:
    r = {cls}(c, 3, "cpu", d, overrides)
    r.setup()
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.phiseg, benchmark.reference.unet, benchmark.reference.metrics
import benchmark.reference.augment, benchmark.reference.optim
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}} & {{"unet_zoo_tpu_torch", "unet_zoo_tpu", "jax"}})))
"""


def _python(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_and_setup_load_nothing_of_jax():
    for cell, module, cls in (("phiseg_lidc.train_bs12", "train", "TrainRun"),
                              ("phiseg_lidc.eval100", "evaluate", "EvalRun")):
        assert _python(SETUP.format(root=spec.ROOT, module=module, cls=cls, cell=cell)) == []


def test_reference_imports_nothing_of_the_program():
    assert _python(REFERENCE.format(root=spec.ROOT)) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    from benchmark import run

    loaded = "unet_zoo_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "unet_zoo_tpu_torch.bench_probe", types.ModuleType("probe"))
    assert loaded or "unet_zoo_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "unet_zoo_tpu.bench_probe", types.ModuleType("probe"))
    assert "unet_zoo_tpu" in run.forbidden_modules()
