"""The trace reader's interval arithmetic and gap labels."""

from port_bench import trace


def test_union_and_gaps():
    busy, gaps = trace.union_and_gaps([(10, 20), (15, 30), (40, 50)], 0, 60)
    assert busy == 30
    assert gaps == [(0, 10), (30, 40), (50, 60)]
    assert trace.union_and_gaps([], 0, 5) == (0, [(0, 5)])


def test_gap_labels_take_the_latest_innermost_event_of_any_thread():
    gaps = [(0, 10), (30, 40), (50, 60), (70, 80)]
    main = [(0, 100, "step"), (28, 45, "aten::mul"), (29, 31, "short")]
    worker = [(48, 65, "autograd::engine"), (49, 64, "aten::mm")]
    labels = trace.label_gaps(gaps, [main, worker])
    assert labels == ["step", "aten::mul", "aten::mm", "step"]
    assert trace.label_gaps(gaps[:1], []) == [trace.NO_HOST]
    assert trace.label_gaps([(5, 7)], [[(0, 2, "early")]]) == [trace.NO_HOST]


def test_measure_runs_the_least_count_and_the_trace_window():
    import torch
    calls = []
    rec = trace.measure(calls.append, 0.0, torch.device("cpu"), min_count=3,
                        trace_s=0.01, shapes={"k": 1})
    assert rec["attempted"] == 3 == len(rec["times_s"])
    assert calls[:3] == [0, 1, 2] and rec["traced_count"] == len(calls) - 3
    assert rec["trace"] is None and rec["launch_shapes"] == {}
    assert rec["window_s"] >= sum(rec["times_s"])


def test_idle_share_reads_the_untraced_calls():
    tr = trace.Trace(2.0, [], 1.5, [], [])
    # 0.5 s of device a call in a 1.0 s untraced call: half idle
    rec = {"trace": tr, "traced_count": 3, "attempted": 10, "window_s": 10.0}
    assert trace.untraced_idle_pct(rec) == 50.0
    assert trace.untraced_idle_pct(dict(rec, trace=None)) is None
