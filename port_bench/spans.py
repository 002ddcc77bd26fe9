"""The program's spans in a traced run of a cell: a host-clock table of a
spans window, and the traced window's device trace attributed to spans.

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does and prints one JSON line: the
traced line, with the span metrics of the cell's driver (SPAN_METRICS,
read by `port_bench/metrics/<name>.py`), "spans" (per request or step:
count, host total and self ms from the spans window; device ms, kernels
and idle ms from the traced window), "breakdown.idle_by_span",
"outside_spans" (the device and idle time that no span holds),
"recording_cost_pct" and "window_noise_pct".

The program records spans only under `profiling.recording()`, which
run.py's `trace.measure` does not open. So this tool runs the cell with
`measure_with_spans` in place of `trace.measure`: the same untraced
window, then a window of the traced window's length (three calls at
least) under `recording()` alone, then the traced window under
`recording()` and the profiler. There each span is also a host range of
the trace; those ranges are kept out of `trace.read`, so `idle_gaps` reads
what run.py's would. This is the one module of the benchmark besides
`system.py` that imports the program.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run, trace  # noqa: E402

PREFIX = "i2i."
ROOTS = {"serve_closed": "i2i.serve.run", "train_steps": "i2i.train.step"}
SPAN_METRICS = {   # by driver: {metric: unit}
    "serve_closed": {"host_enqueue_pct.serve": "%",
                     "vae_encode_device_ms.serve": "ms",
                     "unet_device_ms.serve": "ms",
                     "vae_decode_device_ms.serve": "ms"},
    "train_steps": {"host_enqueue_pct.train": "%",
                    "lora_merge_host_ms.train": "ms",
                    "optim_host_ms.train": "ms",
                    "gen_backward_host_ms.train": "ms"}}
GEN_PASSES = ("i2i.train.gen_pass1", "i2i.train.gen_pass2")
MIN_CALLS = 3
OP_NAME = 96    # characters of a device operation's name in the line


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cuLaunchKernel, cudaMemcpyAsync, ...): what CUPTI correlates with the
    device operation it enqueued."""
    import torch
    return (e.device_type() == torch.autograd.DeviceType.CPU
            and not e.is_user_annotation() and e.name().startswith("cu"))


def split_events(events):
    """A profile's events as plain tuples: (window or None, device ops
    [(name, start, end, correlation)], launches {correlation: start},
    spans [(start, end, name, thread)] of the program)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window, device, launches, spans = None, [], {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.end_ns(),
                               e.correlation_id()))
        elif e.name() == trace.WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif e.name().startswith(PREFIX):
            spans.append((e.start_ns(), e.end_ns(), e.name(),
                          e.start_thread_id()))
        elif _is_launch(e):
            launches[e.correlation_id()] = e.start_ns()
    return window, device, launches, spans


def _innermost(times, spans) -> List[Optional[str]]:
    """The innermost span open at each time (of every thread's, the
    latest started: `trace.label_gaps`' rule), or None."""
    threads = collections.defaultdict(list)
    for s, t, name, th in spans:
        threads[th].append((s, t, name))
    order = sorted(range(len(times)), key=times.__getitem__)
    labels = trace.label_gaps([(times[i], times[i]) for i in order],
                              threads.values())
    out: List[Optional[str]] = [None] * len(times)
    for i, lab in zip(order, labels):
        out[i] = None if lab == trace.NO_HOST else lab
    return out


def attribute(window, device, launches, spans) -> Optional[dict]:
    """Each device operation in the window to the innermost span open at
    its launch (the host call linked to it by correlation id; its own
    start where none is), each idle gap to the innermost span open at its
    middle. Returns {"by_span": {name: {"device_s", "kernels",
    "idle_s"}}, "outside": {"device_s", "idle_s", "kernels", "ops" (top
    ten by seconds)}, "device_s", "idle_s", "unlinked"} in the window's
    seconds; None without a window or a device operation."""
    if window is None or not device:
        return None
    w0, w1 = window
    ops = [(n, max(s, w0), min(t, w1), c) for n, s, t, c in device
           if t > w0 and s < w1]
    if not ops:
        return None
    when = [launches.get(c, s) for _, s, _, c in ops]
    unlinked = sum(c not in launches for *_, c in ops)
    by_span = collections.defaultdict(
        lambda: {"device_s": 0.0, "kernels": 0, "idle_s": 0.0})
    outside_ops: Dict[str, float] = collections.defaultdict(float)
    for (n, s, t, _), lab in zip(ops, _innermost(when, spans)):
        kernel = not n.startswith(("Memcpy", "Memset"))
        if lab is None:
            outside_ops[n] += (t - s) / 1e9
        row = by_span[lab]
        row["device_s"] += (t - s) / 1e9
        row["kernels"] += kernel
    _, gaps = trace.union_and_gaps(sorted((s, t) for _, s, t, _ in ops),
                                   w0, w1)
    mids = [(s + t) // 2 for s, t in gaps]
    for (s, t), lab in zip(gaps, _innermost(mids, spans)):
        by_span[lab]["idle_s"] += (t - s) / 1e9
    outside = by_span.pop(None, {"device_s": 0.0, "kernels": 0,
                                 "idle_s": 0.0})
    outside["ops"] = sorted(outside_ops.items(), key=lambda kv: -kv[1])[:10]
    return {"by_span": dict(by_span), "outside": outside,
            "device_s": sum((t - s) / 1e9 for _, s, t, _ in ops),
            "idle_s": sum((t - s) / 1e9 for s, t in gaps),
            "unlinked": unlinked}


def _as_profile(events):
    """A stand-in for a profiler that `trace.read` reads `events` from."""
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


@contextlib.contextmanager
def traced_with_spans(device):
    """`trace.traced` that also keeps the profile's events: the holder's
    `result` is the Trace of the events without the program's span ranges
    (so its `idle_gaps` are labelled by torch's operations alone), its
    `events` the whole profile's (split_events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = types.SimpleNamespace(result=None, events=None)
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function(trace.WINDOW):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        prof.stop()
    events = list(trace._events(prof))
    holder.events = split_events(events)
    holder.result = trace.read(_as_profile(without_spans(events)))


def without_spans(events) -> list:
    """The events less the program's span ranges on the host."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    return [e for e in events
            if e.device_type() != cpu or not e.name().startswith(PREFIX)]


def measure_with_spans(root: str, base=trace.measure):
    """A `trace.measure` (same arguments and record) that, with `trace_s`,
    runs a spans window of trace_s seconds (MIN_CALLS calls at least)
    under `profiling.recording()` between the untraced window and the
    traced one, and records the traced window too. Adds "spans_window"
    ({"window_s", "count", "table", "spans"}) and "attribution" (the
    traced window's, or None) to the record."""
    def measure(one, seconds, device, min_count=1, trace_s=0.0,
                shapes=None):
        from img2img_turbo_tpu_torch.utils import profiling
        rec = base(one, seconds, device, min_count)
        if not trace_s:
            return rec
        k = rec["attempted"]
        with profiling.recording() as spans:
            t0 = time.perf_counter()
            n = 0
            while n < MIN_CALLS or time.perf_counter() - t0 < trace_s:
                one(k + n)
                n += 1
            window_s = time.perf_counter() - t0
        rec["spans_window"] = {"window_s": window_s, "count": n,
                               "table": spans.table(root),
                               "spans": list(spans.spans)}
        k += n
        if shapes is not None:
            shapes.clear()
        k0 = k
        with profiling.recording(), traced_with_spans(device) as tr:
            t0 = time.perf_counter()
            while k == k0 or time.perf_counter() - t0 < trace_s:
                one(k)
                k += 1
        rec.update(trace=tr.result, traced_count=k - k0,
                   launch_shapes=dict(shapes or {}),
                   attribution=attribute(*tr.events))
        return rec
    return measure


def host_share_pct(r, name: str) -> Optional[float]:
    """The host time of span `name` over the spans window's, in %."""
    w = r.get("spans_window")
    row = w and w["table"]["spans"].get(name)
    if not row:
        return None
    return 100.0 * row["host_ms"] * w["table"]["units"] / (w["window_s"]
                                                          * 1e3)


def host_ms(r, name: str, under=None) -> Optional[float]:
    """Host ms of span `name` a request or step in the spans window; with
    `under`, of those spans alone that one of the spans named there
    holds."""
    w = r.get("spans_window")
    if not w or not w["table"]["units"]:
        return None
    if under is None:
        row = w["table"]["spans"].get(name)
        return None if row is None else row["host_ms"]
    by = {s.seq: s for s in w["spans"]}

    def held(s):
        while s.parent is not None and s.parent in by:
            s = by[s.parent]
            if s.name in under:
                return True
        return False
    return sum(s.end_ns - s.start_ns for s in w["spans"]
               if s.name == name and held(s)) / 1e6 / w["table"]["units"]


def device_ms_per_image(r, name: str) -> Optional[float]:
    """Device ms a traced image of the operations whose innermost span at
    launch is `name`."""
    att = r.get("attribution")
    if att is None or name not in att["by_span"]:
        return None
    images = r["traced_count"] * r["traffic"]["batch"]
    return att["by_span"][name]["device_s"] / images * 1e3


def span_table(r) -> dict:
    """Per request or step: the spans window's host table with, from the
    traced window, each span's device ms, kernels and idle ms (the
    operations and gaps whose innermost span it is)."""
    host = r["spans_window"]["table"]
    att, n = r.get("attribution"), r.get("traced_count") or 1
    rows = {}
    for name, row in host["spans"].items():
        rows[name] = dict(row)
        if att is not None:
            a = att["by_span"].get(name, {"device_s": 0.0, "kernels": 0,
                                          "idle_s": 0.0})
            rows[name].update(device_ms=a["device_s"] / n * 1e3,
                              kernels=a["kernels"] / n,
                              idle_ms=a["idle_s"] / n * 1e3)
    return {"per": host["per"], "units": host["units"], "spans": rows,
            "counters": host["counters"]}


def outside_spans(r) -> Optional[dict]:
    """The traced window's device and idle time that no span holds, as
    shares of all of it (%), with its operations by name."""
    att = r.get("attribution")
    if att is None:
        return None
    out = att["outside"]
    return {"device_pct": 100.0 * out["device_s"] / att["device_s"],
            "idle_pct": 100.0 * out["idle_s"] / att["idle_s"]
            if att["idle_s"] else 0.0,
            "kernels_per_call": out["kernels"] / r["traced_count"],
            "unlinked_ops": att["unlinked"],
            "ops": [[n[:OP_NAME], s] for n, s in out["ops"]]}


def idle_by_span(r) -> Optional[list]:
    att = r.get("attribution")
    if att is None:
        return None
    rows = sorted(((n, a["idle_s"]) for n, a in att["by_span"].items()),
                  key=lambda kv: -kv[1])
    return [[n, s] for n, s in rows[:10]]


def recording_cost_pct(r) -> float:
    """The spans window's mean call over the untraced window's, less 1,
    in %."""
    w = r["spans_window"]
    return 100.0 * ((w["window_s"] / w["count"])
                    / (r["window_s"] / r["attempted"]) - 1.0)


def window_noise_pct(r) -> Optional[list]:
    """The untraced window cut into runs of calls as long as the spans
    window: [min, max] of their mean call over the window's, less 1, in %
    (the windows' own spread, beside recording_cost_pct)."""
    span_s, times = r["spans_window"]["window_s"], r["times_s"]
    means, run_t, n = [], 0.0, 0
    for t in times:
        run_t, n = run_t + t, n + 1
        if run_t >= span_s:
            means.append(run_t / n)
            run_t, n = 0.0, 0
    if not means:
        return None
    mean = sum(times) / len(times)
    return [100.0 * (min(means) / mean - 1), 100.0 * (max(means) / mean - 1)]


def run_spans(root, name, seed, seconds, device, **kw):
    """run.run_cell(..., trace=1) with `measure_with_spans`; returns
    (record, line) with the span keys and metrics added to the line."""
    cell = run.Cell(root, name)
    driver = cell.traffic["driver"]
    orig = trace.measure
    trace.measure = measure_with_spans(ROOTS[driver], orig)
    try:
        rec, line, lines = run.run_cell(root, name, seed, seconds, 1, device,
                                        **kw)
    finally:
        trace.measure = orig
    for m, unit in SPAN_METRICS[driver].items():
        value = cell.reader(m).read(rec)
        if value is not None:
            line["metrics"][m] = {"value": value, "unit": unit}
    line["spans"] = span_table(rec)
    line.setdefault("breakdown", {})["idle_by_span"] = idle_by_span(rec)
    line["outside_spans"] = outside_spans(rec)
    line["recording_cost_pct"] = recording_cost_pct(rec)
    line["window_noise_pct"] = window_noise_pct(rec)
    return rec, line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = run.Cell(run.ROOT, args.workload)
    if not run._card_count_ok(cell.entry["chips"]):
        print(f"{args.workload}: needs {cell.entry['chips']} CUDA card(s)",
              file=sys.stderr)
        return 2
    import torch
    torch.cuda.set_device(0)
    rec, line, lines = run_spans(run.ROOT, args.workload, args.seed,
                                 args.seconds, "cuda")
    bad = run.forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    w = rec["spans_window"]
    print(f"{args.workload} seed {args.seed}: untraced "
          f"{rec['attempted']} calls, median "
          f"{statistics.median(rec['times_s'])!r} s; spans window "
          f"{w['count']} calls in {w['window_s']!r} s; traced "
          f"{rec['traced_count']} calls", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
