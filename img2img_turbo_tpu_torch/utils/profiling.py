"""Tracing and timing helpers (counterpart of
`img2img_turbo_tpu/utils/profiling.py`; the reference has none).

- `trace(log_dir)` records a `torch.profiler` trace (host ops and, on a
  CUDA card, its kernels) and writes it as a Chrome trace into `log_dir`.
- `span(name)` (or the decorator `spanned`) marks a stage of a request
  or train step (names begin with `i2i.`), `count(name, n)` counts work
  where it happens, and `recording()` turns the spans on and reads them
  per request or step. Recording is off by default, and then a span
  costs one flag check.
  Under `trace` with recording on, every span is also a range on the
  host track of the Chrome trace, on the device events' clock.
- `device_time_per_call(fn, args, iters)` measures a call's device time
  from the profiler's device events: the GPU kernels each call launched,
  summed per call (p50 and p90 over the calls), and the device span a
  call. `{}` when the run records no device event (on the CPU), as the
  JAX function returns without a device track.
- `device_memory_stats()` reads `torch.cuda.memory_stats` of every card.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write `<log_dir>/trace_<pid>_<ns>.json`, a
    Chrome trace (chrome://tracing, Perfetto); yields the profiler."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

MAX_SPANS = 1 << 16     # finished spans kept: a server must not grow
counts: collections.Counter = collections.Counter()
_NULL = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None


class Span(NamedTuple):
    """A finished span: `seq` numbers the spans in the order they opened;
    `parent` is the parent's `seq` (None at the top); `unit` is the id of
    the request or step that was running when it opened."""
    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    unit: int
    thread: int


def span(name: str, unit: bool = False):
    """A context manager that records the block as the span `name` while
    `recording()` is on; otherwise one shared null context. unit=True
    marks the span of a whole request or step: the unit id increments as
    it opens, and the spans opened until the next one carry it."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _OpenSpan(rec, name, unit)


def spanned(name: str, unit: bool = False):
    """A decorator: each call of the function runs inside
    `span(name, unit)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, unit):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide counter `counts[name]` (always on)."""
    counts[name] += n


class _OpenSpan:
    __slots__ = ("rec", "name", "unit", "uid", "seq", "parent", "start",
                 "child_ns", "range")

    def __init__(self, rec, name, unit):
        self.rec, self.name, self.unit = rec, name, unit

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        # autograd's backward thread has no span of its own open: its
        # spans belong to the latest-opened one, the caller's
        self.parent = stack[-1] if stack else next(reversed(rec._open),
                                                   None)
        if self.unit:
            rec.units += 1
        self.uid = rec.units
        self.seq, rec._seq = rec._seq, rec._seq + 1
        self.child_ns = 0
        stack.append(self)
        rec._open[self] = None
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = rec.clock()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        end = rec.clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec._stack().pop()
        del rec._open[self]
        dur, parent = end - self.start, self.parent
        if parent is not None:
            parent.child_ns += dur
        agg = rec._agg[self.name]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child_ns
        rec.spans.append(Span(self.seq, self.name, self.start, end,
                              None if parent is None else parent.seq,
                              self.uid, threading.get_ident()))
        return False


class Recorder:
    """What `recording()` collects: `spans`, the last MAX_SPANS finished
    spans; running totals by span name; the counters."""

    def __init__(self, clock: Callable[[], int]):
        self.clock = clock
        self.spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.units = 0
        self._seq = 0
        self._agg = collections.defaultdict(lambda: [0, 0, 0])
        self._open: Dict[_OpenSpan, None] = {}   # open spans, by start
        self._local = threading.local()
        self._counts: Optional[Dict[str, int]] = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def counters(self) -> Dict[str, int]:
        """The counters since recording opened (frozen when it closed)."""
        return dict(counts if self._counts is None else self._counts)

    def table(self, per: str) -> dict:
        """Per request or step, `per` naming its span (say
        "i2i.serve.run"): {"per", "units" (how many closed), "spans":
        {name: {"count", "host_ms", "self_ms"}}, "counters": {name:
        value}}. Self time is a span's time less its child spans'."""
        n = self._agg[per][0] if per in self._agg else 0
        if not n:
            return {"per": per, "units": 0, "spans": {}, "counters": {}}
        return {"per": per, "units": n,
                "spans": {name: {"count": c / n, "host_ms": t / n / 1e6,
                                 "self_ms": own / n / 1e6}
                          for name, (c, t, own) in sorted(self._agg.items())},
                "counters": {k: v / n
                             for k, v in sorted(self.counters().items())}}


@contextlib.contextmanager
def recording(clock: Callable[[], int] = time.perf_counter_ns):
    """Turn spans on for the block, with the counters reset as it opens;
    yields the Recorder, which keeps what it holds after the block."""
    global _recorder
    counts.clear()
    rec = _recorder = Recorder(clock)
    try:
        yield rec
    finally:
        _recorder = None
        rec._counts = dict(counts)


def _device_kernels(prof) -> list:
    """(start_us, end_us) of every GPU kernel of a profile (record_function
    ranges, which also show on the device, left out)."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            out.append((evt.time_range.start, evt.time_range.end))
    return out


def device_time_per_call(fn, args, iters: int = 10,
                         trace_dir: Optional[str] = None) -> Dict[str, float]:
    """Device time of `fn(*args)` a call, from a profiler trace of `iters`
    calls after one warm-up call. Each call is followed by a device
    synchronisation, so its kernels run between its start and the next
    call's; a kernel belongs to the call whose host start precedes it.

    - `device_p50_per_call_s` / `device_p90_per_call_s`: the percentiles
      over the calls of the summed durations of each call's GPU kernels
      (the device's busy time; gaps between kernels, host time, are not
      counted);
    - `device_span_per_call_s`: first kernel start to last kernel end over
      all calls, divided by `iters` (host gaps included);
    - `device_busy_total_s`, `iters`, `kernels_per_call`.
    `{}` when no GPU kernel was recorded. `trace_dir`: also write the
    Chrome trace there."""
    from torch.profiler import profile, record_function
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    with profile(activities=_activities()) as prof:
        for i in range(iters):
            with record_function(f"device_time_per_call_{i}"):
                fn(*args)
                sync()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"device_time_{os.getpid()}_{time.time_ns()}.json"))
    kernels = _device_kernels(prof)
    if not kernels:
        return {}
    marks = sorted(e.time_range.start for e in prof.events()
                   if e.name.startswith("device_time_per_call_")
                   and e.device_type == torch.autograd.DeviceType.CPU)
    per_call = np.zeros(max(len(marks), 1))
    counts = np.zeros_like(per_call)
    for s, e in kernels:
        i = max(int(np.searchsorted(marks, s, side="right")) - 1, 0)
        per_call[i] += (e - s) / 1e6
        counts[i] += 1
    span = (max(e for _, e in kernels) - min(s for s, _ in kernels)) / 1e6
    return {"device_p50_per_call_s": float(np.percentile(per_call, 50)),
            "device_p90_per_call_s": float(np.percentile(per_call, 90)),
            "device_span_per_call_s": span / iters,
            "device_busy_total_s": float(per_call.sum()),
            "iters": iters,
            "kernels_per_call": float(counts.mean())}


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{device name: {"bytes_in_use_gib", "peak_bytes_gib"}} of every CUDA
    card (`torch.cuda.memory_stats`: allocated bytes now and at peak);
    empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": ms.get("allocated_bytes.all.current", 0)
            / 2 ** 30,
            "peak_bytes_gib": ms.get("allocated_bytes.all.peak", 0) / 2 ** 30,
        }
    return out
