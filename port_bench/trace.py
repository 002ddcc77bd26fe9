"""Reading a torch.profiler trace of the measured window: the device's
operations, its busy time, and what the host was doing while it idled.

The benchmark marks the window with the host span `WINDOW`; device times
outside it are clipped. A gap is labelled by the innermost host operation
or span running at its middle: on each host thread the innermost one open
then, and of those the one that started last (the backward runs on
autograd's own thread).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import types
from typing import Dict, List, Optional, Tuple

WINDOW = "port_bench.window"
NO_HOST = "(no host event)"


@dataclasses.dataclass
class Trace:
    window_s: float
    kernels: List[Tuple[str, int, float]]    # (name, start_ns, seconds)
    busy_s: float
    device_ops: List[Tuple[str, float]]      # top 10 by summed seconds
    idle_gaps: List[Tuple[str, float]]       # top 10 host labels by seconds

    @property
    def kernel_count(self) -> int:
        return len(self.kernels)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phases(dict):
    """Seconds of each set-up phase by the host clock, each ending at a
    device synchronisation; the first, "imports", runs from t0."""

    def __init__(self, t0: float, device):
        super().__init__(imports=time.perf_counter() - t0)
        self.device, self.mark = device, time.perf_counter()

    def end(self, name: str):
        sync(self.device)
        now = time.perf_counter()
        self[name], self.mark = now - self.mark, now


def measure(one, seconds, device, min_count=1, trace_s=0.0, shapes=None):
    """The measured window: one(k) for k = 0, 1, ..., each call ending at
    a device synchronisation, until `seconds` have passed and `min_count`
    calls have run, with the device's peak memory reset when it opens.
    With `trace_s`, a further window of that many seconds (one call at
    least) under the profiler, after the launch counter `shapes` is
    cleared. Returns {"t_start", "times_s" (one a call), "attempted",
    "window_s", "peak_bytes" and "setup_peak_bytes" (on a card), "trace"
    (a Trace or None) and, traced, "traced_count" and "launch_shapes"}."""
    import torch
    rec = {"trace": None}
    if device.type == "cuda":
        rec["setup_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    t_start = time.perf_counter()
    t_end, k = t_start, 0
    while k < min_count or t_end - t_start < seconds:
        ts = time.perf_counter()
        one(k)
        t_end = time.perf_counter()
        times.append(t_end - ts)
        k += 1
    rec.update(t_start=t_start, times_s=times, attempted=len(times),
               window_s=t_end - t_start)
    if device.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace_s:
        if shapes is not None:
            shapes.clear()
        k0 = k
        with traced(device) as tr:
            t0 = time.perf_counter()
            while k == k0 or time.perf_counter() - t0 < trace_s:
                one(k)
                k += 1
        rec.update(trace=tr.result, traced_count=k - k0,
                   launch_shapes=dict(shapes or {}))
    return rec


def release(device):
    """Free what the program left: collect, and return the allocator's
    cached blocks to the card."""
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def untraced_idle_pct(r):
    """The device's idle share of the untraced window, in %: 1 - the
    traced window's device busy time a call over the untraced window's
    mean call time (the profiler's host cost stays out of it); None
    without a trace."""
    tr = r.get("trace")
    if tr is None or not r.get("traced_count") or not r["attempted"]:
        return None
    busy = tr.busy_s / r["traced_count"]
    return 100.0 * (1.0 - busy / (r["window_s"] / r["attempted"]))


@contextlib.contextmanager
def traced(device):
    """Profile the block (host operations and, on a card, its device
    operations) as the window `WINDOW`; the yielded holder's `result` is
    then its Trace, or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = types.SimpleNamespace(result=None)
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function(WINDOW):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        prof.stop()
    holder.result = read(prof)


def _events(prof):
    return prof.profiler.kineto_results.events()


def read(prof) -> Optional[Trace]:
    """The window's Trace, or None when the profile holds no device
    operation (no card, or a profiler that did not trace it)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, host = [], []
    for e in _events(prof):
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
            continue
        if e.name() == WINDOW:
            window = (start, end)
        host.append((start, end, e.name(), e.start_thread_id()))
    if window is None or not device:
        return None
    w0, w1 = window
    device = [(n, max(s, w0), min(t, w1)) for n, s, t in device
              if t > w0 and s < w1]
    if not device:
        return None
    kernels = [(n, s, (t - s) / 1e9) for n, s, t in device
               if not n.startswith(("Memcpy", "Memset"))]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, t in device:
        by_name[n] += (t - s) / 1e9
    busy, gaps = union_and_gaps(sorted((s, t) for _, s, t in device),
                                 w0, w1)
    threads = collections.defaultdict(list)
    for s, t, n, th in host:
        if n != WINDOW and t > w0 and s < w1:
            threads[th].append((s, t, n))
    labels = label_gaps(gaps, threads.values())
    idle: Dict[str, float] = collections.defaultdict(float)
    for (s, t), lab in zip(gaps, labels):
        idle[lab] += (t - s) / 1e9
    top = (lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10])
    return Trace((w1 - w0) / 1e9, kernels, busy / 1e9, top(by_name),
                 top(idle))


def union_and_gaps(intervals, w0, w1):
    """(busy ns, idle gaps [(start, end)]) of sorted intervals in
    [w0, w1]."""
    busy, gaps, cur = 0, [], w0
    run_s = run_t = None
    for s, t in intervals:
        if run_t is None or s > run_t:
            if run_t is not None:
                busy += run_t - run_s
            if s > cur:
                gaps.append((cur, s))
            run_s, run_t = s, t
        else:
            run_t = max(run_t, t)
        cur = max(cur, run_t)
    if run_t is not None:
        busy += run_t - run_s
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def label_gaps(gaps, threads) -> List[str]:
    """Each gap's label: of the innermost events open at its middle on
    each thread (`threads`: lists of (start, end, name)), the latest
    started."""
    per_thread = [_label_gaps(gaps, sorted(evts)) for evts in threads]
    return [max(cands)[1] for cands in zip(*per_thread)] if per_thread \
        else [NO_HOST] * len(gaps)


def _label_gaps(gaps, host):
    """(start, name) of the innermost event of one thread's `host` open at
    each gap's middle ((0, NO_HOST) when none is: a thread's
    events nest), swept in time order with a stack."""
    labels, stack, i = [], [], 0
    for s, t in gaps:
        mid = (s + t) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        labels.append((stack[-1][0], stack[-1][2]) if stack
                      else (0, NO_HOST))
    return labels
