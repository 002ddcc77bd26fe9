"""On the card, at each cell's own size: the program within every limit
and the control (the reference in float8 e4m3, the precision below the
configuration's bf16) outside at least one, seed by seed. Each seed is a
short run of the cell (its own weights, traffic and sample). The seeds
come from PORT_BENCH_SEEDS (comma-separated), the first
PORT_BENCH_CONTROL_SEEDS of them (3 by default) with the control; each
run prints its readings as a JSON line, the readings the limits in
port_bench/workloads/ are set from.

    python3 -m pytest port_bench/tests -m card -q -s
"""

import json
import os
import time

import pytest

from port_bench import compare, run

SEEDS = [int(s) for s in os.environ.get(
    "PORT_BENCH_SEEDS", "2147483659,3221225473,4294967311").split(",")]
N_CONTROL = int(os.environ.get("PORT_BENCH_CONTROL_SEEDS", "3"))
CELLS = os.environ.get(
    "PORT_BENCH_CELLS",
    "edge_b8_512,day2night_b2_720p,edge_train_b4_512").split(",")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits_and_control_outside(card, cell):
    limits = run.Cell(run.ROOT, cell).spec["limits"]
    failures = []
    for i, seed in enumerate(SEEDS):
        control = i < N_CONTROL
        rec, line, _ = run.run_cell(run.ROOT, cell, seed, 2.0, 0, "cuda",
                                    control=control, t0=time.perf_counter())
        print(json.dumps({"cell": cell, "seed": seed,
                          "program": rec["numbers"],
                          "control": rec.get("control_numbers"),
                          "attempted": rec["attempted"],
                          "setup_s": rec["setup_s"],
                          "check_s": rec["check_s"]}), flush=True)
        if not line["correct"]:
            failures.append(f"seed {seed}: program {rec['numbers']}")
        if control and compare.judge(rec["control_numbers"], limits)[0]:
            failures.append(f"seed {seed}: control within the limits "
                            f"{rec['control_numbers']}")
    assert not failures, failures


def _summary(w, cfg, batches, noises):
    from port_bench.reference import paired_step
    return compare.train_summary(paired_step.run(w, cfg, batches, noises))


@pytest.mark.card
def test_training_faults_planted_in_the_reference(card, monkeypatch):
    """The training cell's faults at its own size, planted in the reference
    put in the program's place: half of the batch left out (the mean over
    the rest), and the generator's image altered where it is produced (the
    first row scaled by 0.9); each must fail a limit. A state left
    unchanged reads update_gap 1 and needs no run."""
    import torch
    from port_bench.reference import paired_step
    cell = run.Cell(run.ROOT, "edge_train_b4_512")
    drv = run.load_module(cell.driver_path, "port_bench_driver_train")
    cfg, tr, limits = cell.cfg, cell.traffic, cell.spec["limits"]
    failures = []
    for seed in SEEDS[:3]:
        w, batches, noises = drv.reference_inputs(cfg, tr, seed, card,
                                                  torch.bfloat16)
        h = tr["batch"] // 2
        with compare.fp32_exact():
            ref = _summary(w, cfg, batches, noises)
            half = _summary(w, cfg, [{k: v[:h] for k, v in b.items()}
                                     for b in batches],
                            [tuple(n[:h] for n in pair) for pair in noises])
            orig, calls = paired_step.generate, [0]

            def altered(*args, **kw):
                # the reference's generator passes run row by row: the
                # first call of each pass is the batch's first row
                out = orig(*args, **kw)
                first = calls[0] % tr["batch"] == 0
                calls[0] += 1
                return out * 0.9 if first else out
            monkeypatch.setattr(paired_step, "generate", altered)
            alt = _summary(w, cfg, batches, noises)
            monkeypatch.setattr(paired_step, "generate", orig)
        for name, got in (("half_batch", half), ("altered", alt)):
            r = compare.train_readings(got, ref)
            print(json.dumps({"seed": seed, "fault": name, "readings": r}),
                  flush=True)
            if compare.judge(r, limits)[0]:
                failures.append(f"seed {seed}: {name} within the limits {r}")
    assert not failures, failures
