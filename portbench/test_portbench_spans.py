"""The readers of the program's span recorder (`program_spans` and the
metrics whose source is `program_span`) on both cells at their CPU test
sizes: every such metric a finite value over the measured window, None
without the recorder or when its ring dropped part of the window, and the
serve call's admit events in the windows the plain lane model
(`reference/schedule.py`) admits each request in."""
import math
import time

import pytest
import torch

from portbench import bench, program_spans
from portbench.reference import schedule

BM = bench.load_benchmark()
SEED = 2 ** 31 + 23
NEW = [m for m in BM["per_layer"] if m["source"] == "program_span"]


def _cells():
    return sorted({w for m in NEW for w in m["workloads"]})


@pytest.fixture(scope="module")
def runs():
    """Each cell's record and its new metrics, read right after its
    measured window (the recorder is shared by the process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name in _cells():
            _, c = bench.make_cell(BM, name, SEED, "cpu", small=True)
            c.setup(1.0)
            c.run(1.0, trace=False)
            rec = c.record()
            values = {m["name"]: bench.load_module(
                bench.reader_path(m["name"])).read(rec)
                for m in NEW if name in m["workloads"]}
            out[name] = (c, rec, values, program_spans.measured(rec))
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("metric", [m["name"] for m in NEW])
def test_every_span_metric_reads_a_finite_value(metric, runs):
    m = next(x for x in NEW if x["name"] == metric)
    assert m["workloads"]
    for cell in m["workloads"]:
        v = runs[cell][2][metric]
        assert isinstance(v, float) and math.isfinite(v), (cell, v)
        assert v >= 0.0
        if m["unit"] == "ratio":
            assert v < 1.0


def test_the_measured_window_is_the_cells_own(runs):
    for name, (c, rec, _, wins) in runs.items():
        assert wins and all(w["stamps"] is not None for w in wins)
        if "calls" in rec:
            assert len(wins) == sum(len(x["serve_log"]) for x in rec["calls"])
        else:
            assert len(wins) == rec["windows"]
        assert [w["cycle"] is None for w in wins].count(True) == \
            len(program_spans.ranges(rec))


def test_without_the_recorder_every_span_metric_is_left_out(runs,
                                                            monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    for name, (_, rec, values, _) in runs.items():
        for metric in values:
            assert bench.load_module(bench.reader_path(metric)).read(
                rec) is None


def test_a_record_the_ring_cut_is_left_out(runs, monkeypatch):
    spans = program_spans.recorder()
    for name, (_, rec, values, _) in runs.items():
        lo = program_spans.ranges(rec)[0][0]
        monkeypatch.setattr(spans, "_dropped_t", lo - 1)
        assert program_spans.measured(rec) is not None
        monkeypatch.setattr(spans, "_dropped_t", lo)
        assert program_spans.measured(rec) is None
        for metric in values:
            assert bench.load_module(bench.reader_path(metric)).read(
                rec) is None, (name, metric)


def test_admit_events_follow_the_plain_lane_model(runs):
    _, rec, _, wins = runs["chatglm3-6b.chat"]
    spans = program_spans.recorder()
    entries = spans.records()
    for call in rec["calls"]:
        lo, hi = int(call["t0"] * 1e9), int(call["t1"] * 1e9)
        (cid,) = [e["id"] for e in entries if e["kind"] == "span"
                  and e["name"] == "serve.call" and lo <= e["t0"] <= hi]
        got = {e["rid"]: e["window"] for e in entries
               if e["kind"] == "event" and e["name"] == "admit"
               and e["call"] == cid}
        want = {}
        for i, w in enumerate(schedule.windows(
                call["sizes"], rec["lanes"], rec["window"], rec["max_len"])):
            for _, rid, _ in w["running"]:
                want.setdefault(rid, i)
        assert got == want
