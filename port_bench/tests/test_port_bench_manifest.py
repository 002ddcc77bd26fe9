"""BENCHMARK.json against the benchmark's contract, every file a cell names,
and a cell added from files alone."""

import json
import re
import shutil

import pytest

from port_bench import run

ROOT = run.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert MANIFEST["command"][1].startswith("port_bench/")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    entries = MANIFEST[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if kind == "end_to_end":
            assert set(e) - {"workloads"} == E2E_KEYS
            assert 0.01 <= e["bound"] <= 0.25
            assert e["source"] in ("host_clock", "device_trace")
        if kind == "per_layer":
            assert set(e) - {"workloads"} == LAYER_KEYS
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert "\n" not in e["layer"] and len(e["layer"]) <= 200
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        if kind == "workloads":
            assert e["chips"] in (1, 4) and len(e["why"]) <= 200
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_metric_cells_are_consistent():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        c = run.Cell(ROOT, cell)
        names = [m["name"] for m in c.metrics(False)]
        assert "setup_s" in names and len(names) >= 2
        assert c.metrics(True), cell


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names_resolves(cell):
    c = run.Cell(ROOT, cell)
    assert c.driver_path.exists()
    assert c.cfg["name"] == c.entry["config"]
    from port_bench import compare
    numbers = {"serve_closed": compare.NUMBERS,
               "train_steps": compare.TRAIN_NUMBERS}[c.traffic["driver"]]
    assert set(c.spec["limits"]) == set(numbers)
    for m in c.metrics(False) + c.metrics(True):
        assert callable(c.reader(m["name"]).read)
    conf = {e["name"]: e for e in MANIFEST["configs"]}[c.entry["config"]]
    assert (ROOT / conf["file"]).exists()
    assert conf["file"].startswith("port_bench/")


def test_a_cell_added_from_files_alone(tmp_path):
    """A new traffic mix and cell, as files and manifest entries in a copy,
    run without any existing file edited."""
    from port_bench.tests.tiny import TINY_TRAFFIC, tiny_cfg
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "port_bench"
    (bench / "traffic" / "closed_b4_256_edge.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "closed_b8_512_edge.json")
                        .read_text()), batch=4, height=256, width=256)))
    (bench / "workloads" / "edge_b4_256.json").write_text(
        (bench / "workloads" / "edge_b8_512.json").read_text())
    manifest["workloads"].append(
        {"name": "edge_b4_256", "config": "pix2pix_turbo_edge",
         "traffic": "closed_b4_256_edge", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("edge_b4_256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    for f in (ROOT / "port_bench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT)
            assert (tmp_path / rel).read_bytes() == f.read_bytes(), rel
    cell = run.Cell(tmp_path, "edge_b4_256")
    assert cell.traffic["batch"] == 4
    import torch
    rec, line, _ = run.run_cell(
        tmp_path, "edge_b4_256", 7, 0.2, 0, "cpu", dtype=torch.float32,
        cfg_override=tiny_cfg(cell.cfg),
        traffic_override=dict(TINY_TRAFFIC, batch=4))
    assert line["correct"] and rec["images"] == 4 * rec["attempted"]
    assert {"setup_s", "serve_images_per_s", "serve_p95_ms"} <= set(
        line["metrics"])
    assert list(line)[-1] == "checks"
