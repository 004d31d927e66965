"""The card tests' layout, on the CPU, where every card test skips.

Each ``tests/test_torch_*_card.py`` imports on the CPU without JAX (the
card's machine has none, and runs them without this suite's
``conftest.py``), and every test in it is marked ``card``. Each
``tools/torch_*.py`` imports without running (its ``__name__`` is not
``"__main__"``) and names no retired script, so the names it takes from
``tests/torch_card.py`` and the benchmark's frozen helpers exist; no tool
takes the card tests' checks (``tests/torch_card_checks.py``), and
``tests/torch_card.py`` imports neither pytest nor JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CARD_MODULES = sorted(p.name for p in (REPO / "tests").glob("test_torch_*_card.py"))
TOOLS = sorted(p.name for p in (REPO / "tools").glob("torch_*.py"))
RETIRED = "chip_" + "smoke"  # the retired one-pass card script, spelt so that a search for its name finds no user

# one process imports every card module in turn and records what each
# brought in of JAX and which of its tests lack the card mark
_IMPORT_ALL = """
import importlib.util, json, sys
sys.path[:0] = [{tests!r}]
out = {{}}
for name in {names!r}:
    before = {{m.split(".")[0] for m in sys.modules}}
    spec = importlib.util.spec_from_file_location(name[:-3], {tests!r} + "/" + name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax = sorted({{m.split(".")[0] for m in sys.modules}} - before & {{"jax", "flax", "unet_zoo_tpu"}})
    marks = mod.__dict__.get("pytestmark", [])
    module_marks = [m.name for m in (marks if isinstance(marks, list) else [marks])]
    tests = [k for k in vars(mod) if k.startswith("test_") and callable(getattr(mod, k))]
    unmarked = [t for t in tests if "card" not in module_marks + [m.name for m in getattr(mod, t).__dict__.get("pytestmark", [])]]
    out[name] = {{"jax": jax, "tests": len(tests), "unmarked": unmarked}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def card_modules():
    code = _IMPORT_ALL.format(tests=str(REPO / "tests"), names=CARD_MODULES)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CARD_MODULES)
def test_card_module_imports_without_jax_and_is_marked(card_modules, name):
    got = card_modules[name]
    assert not got["jax"], f"{name} imports {got['jax']}"
    assert got["tests"] > 0 and not got["unmarked"], f"{name}: tests without the card mark {got['unmarked']}"


def test_card_helpers_import_without_pytest_or_jax():
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]; import torch_card; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'pytest', 'jax', 'flax', 'unet_zoo_tpu'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", f"tests/torch_card.py imports {proc.stdout.strip()}"


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_on_the_cpu(name):
    path = REPO / "tools" / name
    text = path.read_text()
    assert RETIRED not in text, f"{name} still names {RETIRED}"
    assert "torch_card_checks" not in text, f"{name} takes the card tests' checks"
    spec = importlib.util.spec_from_file_location(f"tool_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.__name__ != "__main__" and callable(module.main)
