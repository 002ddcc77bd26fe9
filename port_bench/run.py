"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json at the checkout's
root. Everything it needs is found by name: its configuration in
port_bench/configs/<config>.json, its traffic in
port_bench/traffic/<traffic>.json (which names the driver,
port_bench/drivers/<driver>.py), its limits in
port_bench/workloads/<cell>.json, and each metric's reader in
port_bench/metrics/<metric>.py. With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics. The last line of
standard output is one JSON object; the numbers compared with the
reference, each beside its limit, are its last key and the last lines of
standard error.

Exit codes: 0 with a result; 2 without a CUDA card or with fewer cards
than the cell asks for; 3 when JAX or the JAX package was loaded; any
other failure raises.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# JAX stays out of the process: no library may pull it in by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# kernel and build caches at fixed paths inside the checkout
CACHE = ROOT / ".port_bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "img2img_turbo_tpu")


def forbidden_modules(names=None):
    """The top-level names among `names` (the loaded modules by default)
    that are JAX's or the JAX package's, compared whole:
    img2img_turbo_tpu_torch is not img2img_turbo_tpu."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of the manifest and every file it names."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.manifest = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        bench = self.root / "port_bench"
        self.cfg = load_json(bench / "configs"
                             / f"{self.entry['config']}.json")
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.spec = load_json(bench / "workloads" / f"{name}.json")
        self.driver_path = bench / "drivers" / f"{self.traffic['driver']}.py"
        self.metrics_dir = bench / "metrics"

    def metrics(self, trace: bool):
        """The manifest's metrics this cell reports: end-to-end ones
        without --trace, per-layer ones with it. A metric without
        `workloads` goes to every cell that reports the end-to-end metric
        it moves (end-to-end: every cell)."""
        e2e = [m for m in self.manifest["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str):
        return load_module(self.metrics_dir / f"{metric}.py",
                           "port_bench_metric_" + metric.replace(".", "_"))


def run_cell(root, name, seed, seconds, trace, device, dtype=None,
             cfg_override=None, traffic_override=None, control=False,
             t0=None):
    """The raw record, the result line and the comparison's lines of one
    run of cell `name` on `device`; the overrides replace keys of the
    configuration and the traffic (tests run tiny widths on the CPU), and
    `control` also reads the control on the compared sample."""
    import torch
    cell = Cell(root, name)
    cfg = dict(cell.cfg, **(cfg_override or {}))
    spec = types.SimpleNamespace(
        cfg=cfg, traffic=dict(cell.traffic, **(traffic_override or {})),
        seed=int(seed), seconds=seconds,
        trace=bool(trace), device=torch.device(device),
        dtype=dtype or getattr(torch, cfg["dtype"]),
        t0=T0 if t0 is None else t0,
        check_requests=cell.spec.get("check_requests", 0),
        control=control)
    driver = load_module(cell.driver_path,
                         "port_bench_driver_" + cell.traffic["driver"])
    rec = driver.run(spec)
    rec.update(cell=name, cfg=cfg, traffic=spec.traffic, device=spec.device)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    import port_bench.compare as compare
    correct, lines = compare.judge(rec["numbers"], cell.spec["limits"])
    dev = spec.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1,
        "memory_peak_bytes": rec.get("peak_bytes", 0)}
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics,
            "device": device_info}
    tr = rec.get("trace")
    if trace and tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                             "idle_gaps": [list(x) for x in tr.idle_gaps]}
    line["checks"] = {k: {"value": rec["numbers"][k], "limit": lim}
                      for k, lim in cell.spec["limits"].items()}
    return rec, line, lines


def _card_count_ok(chips: int) -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.device_count() >= chips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(ROOT, args.workload)
    if not _card_count_ok(cell.entry["chips"]):
        print(f"{args.workload}: needs {cell.entry['chips']} CUDA card(s); "
              "none or too few here", file=sys.stderr)
        return 2
    import torch
    torch.cuda.set_device(0)
    rec, line, lines = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                args.trace, "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"{args.workload} seed {args.seed}: setup_s {rec['setup_s']!r} "
          f"{rec['setup_phases']}, compile {rec['compile_s']}, "
          f"requests or steps {rec['attempted']} (the first "
          f"{rec['times_s'][0]!r} s, the median "
          f"{statistics.median(rec['times_s'])!r} s), "
          f"window {rec['window_s']!r} s, checked {rec['checked_images']} "
          f"images in {rec['check_s']!r} s", file=sys.stderr)
    extra = {k: v for k, v in rec["numbers"].items()
             if k not in line["checks"]}
    if extra:
        print(f"not compared: {extra}", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
