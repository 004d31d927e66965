"""The program's spans held against a reduced trace (``harness/spans.py``), on
a small hand-written chrome trace: the record's clock moved onto the
trace's, kernels attributed by launch time under nested and cross-thread
spans (a kernel under two nested convolution spans counted once), the idle
time under spans, the FFT family's names, the readers built on them, and
every existing reader unchanged by the program's ``uz.*`` events."""

import pytest

from benchmark.harness import spans, spec, trace

# the wall clock less the trace's clock, in ns: the record's times are the trace's plus this
WALL_NS = 1_790_000_000_000_000_000
MAIN, AUTOGRAD = 1, 2
# (name, start us, end us) of the harness's spans, on the main thread
BENCH = [("bench.forward_loss", 100.0, 300.0), ("bench.backward", 300.0, 500.0)]
# the program's spans: the step's phases 2-3 us inside the harness's, convolutions (b nested in a)
PROGRAM = [("uz.step.forward_loss", 102.0, 297.0), ("uz.conv.1-8.k3.16x16", 110.0, 150.0),
           ("uz.conv.8-8.k3.16x16", 120.0, 140.0), ("uz.conv.8-8.k3.8x8", 160.0, 200.0),
           ("uz.step.backward", 303.0, 497.0)]
# (name, launch us, thread, device start us, device end us)
KERNELS = [
    ("fft2d_r2c_32x32<float>", 115.0, MAIN, 116.0, 126.0),  # under conv a
    ("sm80_xmma_gemm_cf32cf32_cf32f32_f32_nn_n_tilesize32x32x8", 130.0, MAIN, 130.0, 150.0),  # a and b
    ("bn_fw_tr_1C11_kernel_NCHW", 155.0, MAIN, 155.0, 158.0),  # between the convolutions
    ("void DSE::regular_fft<512>", 170.0, MAIN, 170.0, 185.0),  # under conv c
    ("pointwise_mult_and_sum_complex<float>", 190.0, MAIN, 188.0, 195.0),  # under conv c
    ("vectorized_elementwise_kernel", 250.0, MAIN, 250.0, 260.0),  # the loss
    ("dgrad_engine", 350.0, AUTOGRAD, 350.0, 400.0),  # the backward, launched on autograd's thread
]
FFT = ("void internal::region_transform_ABC_val<int, 32, 32, false, internal::TransformParamsABC<float2>>",
       "void fft2d_c2r_64x64<float, false>", "void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float>")
NOT_FFT = ("bn_fw_tr_1C11_kernel_NCHW", "vectorized_elementwise_kernel", "dgrad_engine",
           "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize64x32x8", "implicit_convolve_sgemm",
           "void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true, false>",
           "void convolve_common_engine_float_NHWC<float, float, 1024, 5, 5, 3, 3, 3, true, false>",
           "void flip_filter<float, float>")


def _events(program=True):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t0, "dur": t1 - t0, "tid": MAIN}
          for n, t0, t1 in BENCH]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": t0 + 1, "dur": t1 - t0 - 2, "tid": MAIN}
           for n, t0, t1 in PROGRAM if n.startswith("uz.conv.8-8.k3.8") or n == "uz.conv.1-8.k3.16x16"]
    for corr, (name, at, tid, d0, d1) in enumerate(KERNELS):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at, "dur": 1.0, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": d0, "dur": d1 - d0, "tid": 7,
                   "args": {"correlation": corr}})
    if program:
        ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t0, "dur": t1 - t0, "tid": MAIN}
               for n, t0, t1 in PROGRAM]
        ev += [{"ph": "X", "cat": "gpu_user_annotation", "name": n, "ts": t0, "dur": t1 - t0, "tid": 7}
               for n, t0, t1 in PROGRAM]
    return ev


def _record():
    """The program's record of ``PROGRAM`` on the wall clock (ns), in the
    order the spans closed, after spans of an earlier window."""
    earlier = [("uz.step.forward_loss", 10.0, 20.0), ("uz.step.backward", 20.0, 30.0)]
    ordered = sorted(earlier + PROGRAM, key=lambda s: s[2])
    return [(n, WALL_NS + round(t0 * 1e3), WALL_NS + round(t1 * 1e3)) for n, t0, t1 in ordered]


@pytest.fixture
def t():
    return trace.Trace(_events())


def test_the_record_moves_onto_the_trace_clock(t):
    got = spans.program_spans(t, _record())
    assert set(got) == {n[3:] for n, _, _ in PROGRAM}
    # the phases open 2-3 us inside the harness's spans: the constant is known to 2.5 us
    for n, t0, t1 in PROGRAM:
        (g0, g1), = got[n[3:]]
        assert abs(g0 - t0) <= 2.5 and abs(g1 - t1) <= 2.5 and g1 - g0 == pytest.approx(t1 - t0)
    assert spans.program_spans(t, []) is None
    assert spans.program_spans(t, [("uz.conv.1-8.k3.16x16", 0, 10)]) is None  # nothing to pair


def test_device_time_under_nested_and_cross_thread_spans(t):
    got = spans.program_spans(t, _record())
    conv = spans.union(got, "conv.")
    assert len(conv) == 2  # b lies inside a
    assert spans.device_s(t, conv) == pytest.approx((10 + 20 + 15 + 7) / 1e6)
    assert spans.device_s(t, spans.union(got, "conv.8-8.k3.16x16")) == pytest.approx(20 / 1e6)
    # the backward's kernel, launched on autograd's thread while the main thread's span was open
    assert spans.device_s(t, spans.union(got, "step.backward")) == pytest.approx(50 / 1e6)
    assert spans.device_s(t, spans.union(got, "step.forward_loss")) == pytest.approx((52 + 3 + 10) / 1e6)


def test_fft_family_names():
    fft = [k for k in KERNELS if any(p in k[0] for p in spans.FFT_KERNELS)]
    assert [k[0] for k in fft] == [k[0] for k in KERNELS[:2] + KERNELS[3:5]]
    assert all(any(p in n for p in spans.FFT_KERNELS) for n in FFT)
    assert not [n for n in NOT_FFT if any(p in n for p in spans.FFT_KERNELS)]


def test_fft_and_idle_under_the_convolutions(t):
    conv = spans.union(spans.program_spans(t, _record()), "conv.")
    assert spans.device_s(t, conv, spans.FFT_KERNELS) == pytest.approx((10 + 20 + 15 + 7) / 1e6)
    # conv a (110-150) is busy 116-126 and 130-150, conv c (160-200) 170-185 and 188-195: idle 6 + 4 + 10 +
    # 3 + 5 us, each span's ends known to the constant's precision
    assert spans.idle_s(t, conv) == pytest.approx(28 / 1e6, abs=3e-6)
    assert spans.idle_s(t, [(0.0, 1000.0)]) == pytest.approx((t.end - t.start - t.busy_s * 1e6) / 1e6)


def test_readers_on_the_trace(t, monkeypatch):
    monkeypatch.setattr(spans, "_program_record", _record)
    ctx = {"kind": "train", "trace": t, "units": 2}
    assert spec.reader("conv_fft_ms.train")(ctx) == pytest.approx(52 / 1e3 / 2)
    assert spec.reader("conv_fft_ms.device_bound")(ctx) == pytest.approx(52 / 1e3 / 2)
    assert spec.reader("conv_idle_ms.train")(ctx) == pytest.approx(28 / 1e3 / 2, abs=2e-3)
    for name in ("sample_ms.eval", "image_metrics_ms.eval", "eval_loss_ms.eval", "conv_fft_ms.eval",
                 "conv_idle_ms.eval"):
        assert spec.reader(name)(ctx) is None  # an evaluation's metric in a train cell
    monkeypatch.setattr(spans, "_program_record", lambda: None)  # a program that records no spans
    assert spec.reader("conv_fft_ms.train")(ctx) is None


def test_existing_readers_ignore_the_program_spans():
    """Every reader that is not the program's spans', and the trace's own
    reductions, read the same with and without the program's ``uz.*``
    events."""
    program = [m["name"] for m in spec.benchmark()["per_layer"] if m["source"] == "program_span"]
    readers = [m["name"] for m in spec.benchmark()["per_layer"] if m["name"] not in program]
    values = []
    for with_program in (False, True):
        host, light = trace.Trace(_events(with_program)), trace.Trace(_events(with_program), window_s=5e-4)
        row = [host.spans, host.start, host.end, host.host_ops, host.busy_s, host.launches(), host.top_ops(),
               host.idle_gaps(), light.busy_s, light.window_s]
        for kind in ("train", "eval"):
            ctx = {"kind": kind, "trace": host, "light": light, "units": 2, "flops": 1e9, "peak_flops": 1e12,
                   "model": object(), "batch": 12, "next_batch_ms": 1.5}
            row += [spec.reader(name)(ctx) for name in readers]
        values.append(row)
    assert values[0] == values[1]
