"""The span tool (`port_bench/spans.py`): attribution of device operations
and idle gaps to the program's spans, the trace reader's gap labels left
as they were, and a tiny CPU run of a cell with its spans window."""

import torch
from pytest import approx

from port_bench import run, spans, trace
from port_bench.tests.tiny import TINY_TRAFFIC, tiny_cfg

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """A kineto event: what `trace.read` and `spans.split_events` call."""

    def __init__(self, name, s, t, dev=CPU, thread=1, corr=0, ann=False):
        self._v = (name, s, t, dev, thread, corr, ann)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _step_events():
    """A step on the main thread (1) whose backward launches from
    autograd's thread (2), a kernel with no launch event, and the driver's
    copy after the step, outside every span."""
    return [
        Ev(trace.WINDOW, 0, 1000, ann=True),
        Ev("i2i.train.step", 0, 900, ann=True),
        Ev("i2i.train.forward", 10, 300, ann=True),
        Ev("i2i.gen.unet", 20, 200, ann=True),
        Ev("aten::mm", 30, 60),
        Ev("cudaLaunchKernel", 40, 45, corr=101),       # under gen.unet
        Ev("cudaLaunchKernel", 250, 255, corr=102),     # under forward
        Ev("i2i.train.backward", 400, 800, ann=True),
        Ev("autograd::engine", 410, 790, thread=2),
        Ev("cuLaunchKernel", 500, 505, thread=2, corr=103),
        Ev("cudaMemcpyAsync", 950, 955, corr=104),
        Ev("gemm", 100, 220, dev=CUDA, corr=101),       # runs after unet
        Ev("elementwise", 260, 280, dev=CUDA, corr=102),
        Ev("bwd_kernel", 510, 600, dev=CUDA, corr=103),
        Ev("orphan", 700, 720, dev=CUDA, corr=999),     # no launch: 700
        Ev("Memcpy DtoH", 960, 990, dev=CUDA, corr=104),
        Ev("i2i.gen.unet", 100, 220, dev=CUDA, ann=True),  # gpu range
    ]


def test_device_operations_go_to_the_span_open_at_their_launch():
    att = spans.attribute(*spans.split_events(_step_events()))
    by = att["by_span"]
    # gemm ran after gen.unet closed on the host, and belongs to it
    assert by["i2i.gen.unet"]["device_s"] == approx(120e-9)
    assert by["i2i.train.forward"]["device_s"] == approx(20e-9)
    # autograd's thread has no span open: the caller's backward holds its
    # launch, and the unlinked kernel too, by its start
    assert by["i2i.train.backward"]["kernels"] == 2
    assert by["i2i.train.backward"]["device_s"] == approx(110e-9)
    assert att["unlinked"] == 1
    out = att["outside"]
    assert out["kernels"] == 0 and out["device_s"] == approx(30e-9)
    assert out["ops"] == [("Memcpy DtoH", approx(30e-9))]
    assert att["device_s"] == approx(280e-9)


def test_idle_gaps_go_to_the_span_open_at_their_middle():
    att = spans.attribute(*spans.split_events(_step_events()))
    by = att["by_span"]
    assert by["i2i.gen.unet"]["idle_s"] == approx(100e-9)      # 0-100
    assert by["i2i.train.forward"]["idle_s"] == approx(40e-9)  # 220-260
    # 280-510 and 720-960
    assert by["i2i.train.step"]["idle_s"] == approx(470e-9)
    assert by["i2i.train.backward"]["idle_s"] == approx(100e-9)  # 600-700
    assert att["outside"]["idle_s"] == approx(10e-9)           # 990-1000
    assert att["idle_s"] == approx(720e-9)


def test_idle_gaps_labels_leave_span_ranges_out():
    """`trace.read` on the profile less the span ranges labels every gap as
    on a profile that never had them; with them it would not."""
    events = _step_events()
    plain = [e for e in events if not e.name().startswith("i2i.")]
    read = (lambda evs: trace.read(spans._as_profile(evs)))
    want = read(plain)
    got = read(spans.without_spans(events))
    assert got.idle_gaps == want.idle_gaps and got.busy_s == want.busy_s
    assert got.kernels == want.kernels
    assert read(events).idle_gaps != want.idle_gaps


def test_spans_reach_a_cpu_profile():
    """With recording on, a span is a host range of an active profile,
    which `split_events` finds."""
    from torch.profiler import ProfilerActivity, profile

    from img2img_turbo_tpu_torch.utils import profiling
    with profiling.recording(), profile(activities=[ProfilerActivity.CPU]) \
            as prof:
        with profiling.span("i2i.test", unit=True):
            torch.ones(2) + 1
    _, _, _, found = spans.split_events(trace._events(prof))
    assert [s[2] for s in found] == ["i2i.test"]


def test_tiny_cpu_run_reads_the_spans_window():
    c = run.Cell(run.ROOT, "edge_b8_512")
    rec, line, _ = spans.run_spans(
        run.ROOT, "edge_b8_512", 2 ** 31 + 21, 0.2, "cpu",
        dtype=torch.float32, cfg_override=tiny_cfg(c.cfg),
        traffic_override=TINY_TRAFFIC)
    assert line["correct"]
    table = line["spans"]
    assert table["per"] == "i2i.serve.run" and table["units"] >= 3
    assert set(table["spans"]) == {
        "i2i.serve.run", "i2i.serve.input", "i2i.gen.encode",
        "i2i.gen.unet", "i2i.gen.decode", "i2i.serve.output"}
    assert table["spans"]["i2i.gen.unet"]["count"] == 1.0
    assert table["counters"].get("weight_packs", 0) == 0
    share = line["metrics"]["host_enqueue_pct.serve"]["value"]
    assert 0 < share <= 100
    # no device trace on the CPU: no device metric, no attribution
    assert "unet_device_ms.serve" not in line["metrics"]
    assert line["outside_spans"] is None
    assert isinstance(line["recording_cost_pct"], float)
    noise = line["window_noise_pct"]
    assert noise is None or noise[0] <= noise[1]
    assert rec["spans_window"]["count"] >= spans.MIN_CALLS
