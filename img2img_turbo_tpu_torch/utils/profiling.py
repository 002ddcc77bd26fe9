"""Tracing and timing helpers (counterpart of
`img2img_turbo_tpu/utils/profiling.py`; the reference has none).

- `trace(log_dir)` records a `torch.profiler` trace (host ops and, on a
  CUDA card, its kernels) and writes it as a Chrome trace into `log_dir`.
- `StepTimer` tracks step time and images a second, discarding warm-up
  steps; its `stats` keys and percentiles are the JAX module's.
- `device_time_per_call(fn, args, iters)` measures a call's device time
  from the profiler's device events: the GPU kernels each call launched,
  summed per call (p50 and p90 over the calls), and the device span a
  call. `{}` when the run records no device event (on the CPU), as the
  JAX function returns without a device track.
- `device_memory_stats()` reads `torch.cuda.memory_stats` of every card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

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


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "step_time_p50_s": float(np.percentile(t, 50)),
            "step_time_p90_s": float(np.percentile(t, 90)),
            "steps_per_sec": float(1.0 / t.mean()),
            "images_per_sec": float(batch_size / t.mean()),
        }


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
