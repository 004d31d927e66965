"""The port's spans (``utils.profiling.span``) on the CPU, on a toy PHiSeg:

* the gate: with no profile active every span is one shared null context
  and nothing records; inside a ``torch.profiler`` profile a span is a
  ``record_function`` named ``uz.<name>``;
* with no profile active no ``record_function`` is entered anywhere in the
  package;
* under a CPU profile, ``Trainer.train`` (2 steps, logging, a validation
  with its checkpoint, a resume) and ``stream_images`` give every span in
  the chrome trace, nested as the loop nests them, each holding the host
  ops issued inside it; ``recorded_spans`` holds the same spans on the
  wall clock, the trace's clock less one constant;
* the loss, the parameters and the evaluation's rows are bit for bit the
  same with and without the profile.
"""

import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.data import LIDCData, synthetic
from unet_zoo_tpu_torch.experiments import ExperimentConfig
from unet_zoo_tpu_torch.ops.conv import Conv, conv_span
from unet_zoo_tpu_torch.training import Trainer
from unet_zoo_tpu_torch.utils import profiling

SIZE = 16
TOY_PHISEG = dict(experiment_name="toy_phiseg", model="phiseg", filter_channels=(4, 8, 8), image_size=(SIZE, SIZE),
                  batch_size=2, validation_samples=2, num_validation_images=1, latent_levels=2,
                  logging_frequency=1, validation_frequency=2)
STEP_SPANS = ("uz.step.augment", "uz.step.forward_loss", "uz.step.backward", "uz.step.update")
EVAL_SPANS = ("uz.eval.sample", "uz.eval.metrics", "uz.eval.loss")
NAMED = ("uz.train.step", "uz.data.next_batch", *STEP_SPANS, "uz.train.log", "uz.train.validate",
         "uz.checkpoint.save", "uz.checkpoint.restore", "uz.phiseg.posterior", "uz.phiseg.prior",
         "uz.phiseg.likelihood", "uz.phiseg.loss", "uz.eval.image", *EVAL_SPANS)
CONV = re.compile(r"^uz\.conv\.\d+-\d+\.k[13]\.\d+x\d+$")
TOY_PROB_UNET = dict(experiment_name="toy_prob_unet", model="prob_unet", filter_channels=(4, 8, 8),
                     image_size=(SIZE, SIZE), batch_size=2, latent_levels=1, latent_dim=6, no_convs_fcomb=3)
PROB_UNET_SPANS = ("uz.prob_unet.prior", "uz.prob_unet.posterior", "uz.prob_unet.trunk", "uz.prob_unet.fcomb",
                   "uz.prob_unet.loss")


def _trainer(tmp_path, name):
    return Trainer(ExperimentConfig(**TOY_PHISEG), device="cpu", seed=5, log_dir=str(tmp_path / name),
                   tensorboard=False)


def _data():
    return LIDCData(synthetic.lidc_splits((8, 2, 2), SIZE, seed=3), seed=0)


def _run(tr, data):
    """Two steps with a validation at the second, a resume from its
    checkpoint, then one test image's evaluation: (last loss, parameters,
    rows)."""
    aux = tr.train(data, iterations=2)
    tr.restore("validation_ckpt")
    (host, _), = list(tr.stream_images(data.test, [1], 3, 2, salt=1))
    return float(aux["loss"]), {n: p.detach().clone() for n, p in tr.state.model.named_parameters()}, host["rows"]


def _profiled(tmp_path, body):
    """``body()`` under a CPU profile: (its result, the chrome trace's events,
    the spans ``recorded_spans`` gained)."""
    before = len(profiling.recorded_spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = body()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    return out, events, profiling.recorded_spans()[before:]


def _spans(events):
    """{name: sorted [(start, end, tid)]} of the trace's ``uz.*`` spans, in us."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(profiling.SPAN_PREFIX):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outers):
    return any(o0 <= inner[0] and inner[1] <= o1 for o0, o1, _ in outers)


def test_span_gate():
    """No profile: the gate is down and every span is the same null context,
    its name never formatted; inside a profile each is a ``uz.`` span."""
    assert not profiling._autograd_profiler._is_profiler_enabled
    before = len(profiling.recorded_spans())
    null = profiling.span("step.augment")
    never = pytest.fail  # a name's function is not called
    assert null is profiling.span(never, "its name's function is called") is profiling._NULL
    with null, null:  # shared and re-entrant
        pass
    assert len(profiling.recorded_spans()) == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling._autograd_profiler._is_profiler_enabled
        s = profiling.span(conv_span, torch.empty((2, 16, 12, 3)), torch.empty((8, 3, 3, 3)))
        assert s is not profiling._NULL and s.name == "uz.conv.3-8.k3.16x12"
        with s:
            pass
    assert not profiling._autograd_profiler._is_profiler_enabled
    assert [r[0] for r in profiling.recorded_spans()[before:]] == ["uz.conv.3-8.k3.16x12"]


def test_no_record_function_without_a_profile(tmp_path, monkeypatch):
    """With no profile active, training, a validation, a resume and an
    evaluation enter no ``record_function`` from the package's code (torch's
    optimizer enters its own); the package names it in the profiling module
    alone."""
    package = pathlib.Path(profiling.__file__).parents[1]
    callers = []
    for module in (torch.profiler, torch.autograd.profiler):
        real = module.record_function

        def entered(*a, _real=real, **k):
            callers.append(sys._getframe(1).f_code.co_filename)
            return _real(*a, **k)

        monkeypatch.setattr(module, "record_function", entered)
    _run(_trainer(tmp_path, "off"), _data())
    assert callers and not [c for c in callers if pathlib.Path(c).is_relative_to(package)]
    sources = [p for p in package.rglob("*.py") if "_build" not in p.relative_to(package).parts]
    users = sorted(p.relative_to(package).as_posix() for p in sources if "record_function" in p.read_text())
    assert users == ["utils/profiling.py"]


def test_spans_of_a_profiled_train_and_evaluation(tmp_path):
    """Every span is in the trace where the loop nests it, and holds the
    host ops issued inside it."""
    _, events, recorded = _profiled(tmp_path, lambda: _run(_trainer(tmp_path, "on"), _data()))
    spans = _spans(events)
    assert set(NAMED) <= set(spans)
    assert len(spans["uz.train.step"]) == 2 and len(spans["uz.train.log"]) == 2
    for name in STEP_SPANS + ("uz.data.next_batch",):
        assert len(spans[name]) == 2 and all(_inside(s, spans["uz.train.step"]) for s in spans[name]), name
    # the validation's image and the test image
    assert len(spans["uz.eval.image"]) == 2
    for name in EVAL_SPANS:
        assert len(spans[name]) == 2 and all(_inside(s, spans["uz.eval.image"]) for s in spans[name]), name
    assert all(_inside(s, spans["uz.train.validate"]) for s in spans["uz.checkpoint.save"])
    convs = {k: v for k, v in spans.items() if k.startswith("uz.conv.")}
    assert convs and all(CONV.match(k) for k in convs)
    assert all(_inside(s, spans["uz.step.forward_loss"] + spans["uz.eval.image"]) for v in convs.values() for s in v)
    ops = [(e["ts"], e["ts"] + e["dur"], e["tid"], e["name"]) for e in events if e.get("cat") == "cpu_op"]
    for name, intervals in spans.items():
        for s0, s1, tid in intervals:
            held = [op for op in ops if op[2] == tid and s0 <= op[0] <= s1]
            assert all(op[1] <= s1 for op in held), name
            if name in convs:
                assert any(op[3] == "aten::conv2d" for op in held), name
    # the same spans on the wall clock: each lies inside its trace span, moved by one constant (the wall
    # clock less the trace's, in us), which the spans bound from below (their ends) and above (their starts)
    assert sorted(r[0] for r in recorded) == sorted(k for k, v in spans.items() for _ in v)
    t_ref = recorded[0][1]
    lo, hi = -np.inf, np.inf
    for name, intervals in spans.items():
        mine = sorted((t0 - t_ref) / 1e3 for n, t0, _ in recorded if n == name)
        ends = sorted((t1 - t_ref) / 1e3 for n, _, t1 in recorded if n == name)
        for (s0, s1, _), r0, r1 in zip(intervals, mine, ends):
            lo, hi = max(lo, r1 - s1), min(hi, r0 - s0)
    assert lo <= hi


def test_a_profile_changes_no_number(tmp_path):
    """The same seed's run with and without the profile: the loss, every
    parameter and the evaluation's rows are equal bit for bit."""
    off = _run(_trainer(tmp_path, "off"), _data())
    on, _, _ = _profiled(tmp_path, lambda: _run(_trainer(tmp_path, "on"), _data()))
    assert off[0] == on[0]
    assert off[1].keys() == on[1].keys() and all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    assert torch.equal(off[2], on[2])


@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_span_names_the_shape(ndim):
    """A convolution's span names its input and output channels, its kernel
    size and its input's spatial shape, in 2D and 3D."""
    conv = Conv(3, 5, 3, generator=torch.Generator().manual_seed(0), ndim=ndim)
    x = torch.randn((2, *(6, 7, 4)[:ndim], 3))
    before = len(profiling.recorded_spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        y = conv(x)
    assert torch.equal(y, conv(x))
    want = "uz.conv.3-5.k3." + "x".join(map(str, x.shape[1:-1]))
    assert [r[0] for r in profiling.recorded_spans()[before:]] == [want]


def test_prob_unet_spans(tmp_path):
    """A ProbUNet step under a profile records its five spans once each,
    inside the step's forward and loss; ``sample`` records the prior's, the
    trunk's and fcomb's; with no profile nothing is recorded."""
    tr = Trainer(ExperimentConfig(**TOY_PROB_UNET), device="cpu", seed=5, log_dir=str(tmp_path / "prob"),
                 tensorboard=False)
    data = _data()
    before = len(profiling.recorded_spans())
    tr.train(data, iterations=1, validate=False)
    with torch.no_grad():
        tr.state.model.sample(torch.zeros((1, SIZE, SIZE, 1)), 2)
    assert len(profiling.recorded_spans()) == before

    def body():
        tr.train(data, iterations=2, validate=False)
        with torch.no_grad():
            tr.state.model.sample(torch.zeros((1, SIZE, SIZE, 1)), 2)

    _, events, recorded = _profiled(tmp_path, body)
    spans = _spans(events)
    names = [r[0] for r in recorded if r[0].startswith("uz.prob_unet.")]
    assert sorted(names) == sorted(PROB_UNET_SPANS + ("uz.prob_unet.prior", "uz.prob_unet.trunk",
                                                      "uz.prob_unet.fcomb"))
    for name in PROB_UNET_SPANS:
        assert _inside(spans[name][0], spans["uz.step.forward_loss"]), name
    for name in ("uz.prob_unet.prior", "uz.prob_unet.trunk", "uz.prob_unet.fcomb"):
        assert len(spans[name]) == 2 and not _inside(spans[name][1], spans["uz.step.forward_loss"]), name
