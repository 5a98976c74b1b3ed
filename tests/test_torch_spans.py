"""The span recorder (`repro_torch.spans`) on the CPU, where the device
clock is the host clock: host spans (nesting, ids, attributes, closing on
an exception), the ring's cap and its count of dropped entries, the
switch, stamps outside a window program; then a small `Server.serve` and
`Engine.serve_steps`: each window one stamps entry with its segments in
order, segments that tile the window's stamped span, host children inside
their window, request events, and a serve log, reports and outputs that do
not depend on the switch."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import pool as pl  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.server import Request, Server, ServerConfig  # noqa

LAYERS, B, EVERY, W = 2, 2, 4, 8
COLLECT = ["collect.classify", "collect.plan", "collect.add_drop",
           "collect.plan", "collect.plan", "collect.add_drop",
           "collect.plan", "collect.migrate", "collect.policy", "backend"]
SERVE_CHILDREN = ["serve.schedule", "serve.upload", "serve.launch",
                  "serve.wait", "serve.unpack"]
_MODEL = []


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    monkeypatch.setattr(spans, "ENABLED", True)
    spans.reset()
    yield
    spans.reset()


def _model():
    if not _MODEL:
        cfg = dataclasses.replace(get_config("chatglm3-6b", reduced=True),
                                  num_layers=LAYERS, dtype="float32")
        m = Model(cfg, device="cpu")
        _MODEL.append((m, m.init(torch.Generator().manual_seed(0))))
    return _MODEL[0]


def _serve():
    """A small serve call: (server, completions)."""
    m, params = _model()
    srv = Server(m, ServerConfig(batch=B, max_len=32, block_tokens=4,
                                 collect_every=EVERY, window=W))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, 256, (int(n),)).tolist(),
                    max_new=int(k))
            for n, k in zip(rng.integers(2, 12, 5), rng.integers(1, 10, 5))]
    return srv, srv.serve(params, reqs)


def _kinds(kind, name=None):
    return [e for e in spans.records() if e["kind"] == kind
            and (name is None or e["name"] == name)]


# -- the recorder ---------------------------------------------------------
def test_spans_nest_with_ids_parents_and_attributes():
    with spans.span("a", call=7) as a:
        with spans.span("b", window=3) as b:
            spans.event("e", rid=1)
        with spans.span("c"):
            pass
    got = {e["name"]: e for e in _kinds("span")}
    assert [e["name"] for e in _kinds("span")] == ["b", "c", "a"]
    assert len({e["id"] for e in got.values()}) == 3
    assert got["a"]["parent"] is None and got["a"]["call"] == 7
    assert got["b"]["parent"] == got["c"]["parent"] == a.id
    assert got["b"]["window"] == 3 and got["b"]["id"] == b.id
    assert got["a"]["t0"] <= got["b"]["t0"] <= got["b"]["t1"] <= \
        got["c"]["t0"] <= got["c"]["t1"] <= got["a"]["t1"]
    (ev,) = _kinds("event")
    assert ev["parent"] == b.id and ev["rid"] == 1
    assert got["b"]["t0"] <= ev["t"] <= got["b"]["t1"]
    start = spans.now()
    with spans.span("d", start=start):
        pass
    assert _kinds("span", "d")[0]["t0"] == start


def test_a_span_closes_on_an_exception():
    with pytest.raises(KeyError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise KeyError("x")
    assert [e["name"] for e in _kinds("span")] == ["inner", "outer"]
    with spans.span("after"):
        pass
    assert _kinds("span", "after")[0]["parent"] is None


def test_the_ring_keeps_the_newest_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "RING", 8)
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=8))
    for i in range(13):
        spans.event("e", i=i)
    assert [e["i"] for e in spans.records()] == list(range(5, 13))
    assert spans.counters["dropped"] == 5


def test_the_ring_tells_when_a_stretch_lost_an_entry(monkeypatch):
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=4))
    for i in range(4):
        spans.event("e", i=i)
    t = spans.now()
    assert not spans.lost_since(0)
    spans.event("e", i=4)                       # drops i=0, closed before t
    assert spans.lost_since(0) and not spans.lost_since(t)
    for i in range(5, 9):                       # drops i=1..4
        spans.event("e", i=i)
    assert spans.lost_since(t) and spans.counters["dropped"] == 5
    spans.reset()
    assert not spans.lost_since(0)


def _window_span(t0, parent, stamp_ns=None):
    wid = 1000 + t0
    win = {"kind": "span", "name": "x.window", "id": wid, "parent": parent,
           "t0": t0, "t1": t0 + 5}
    out = [win]
    if stamp_ns is not None:
        wait = {"kind": "span", "name": "x.wait", "id": -wid, "parent": wid,
                "t0": t0 + 1, "t1": t0 + 4}
        out += [wait, {"kind": "stamps", "program": "x", "parent": -wid,
                       "names": ("start", "a"),
                       "t": np.array([t0, t0 + stamp_ns]),
                       "host_return": t0 + 4}]
    return out


def test_window_cycles_stay_within_a_parent_and_a_part():
    entries = (_window_span(0, 1, 6) + _window_span(10, 1, 4)
               + _window_span(30, 1, 8) + _window_span(100, 2, 2)
               + _window_span(104, 2))
    wins = spans.windows(entries)
    assert [w["cycle"] for w in wins] == [10, 20, None, 4, None]
    assert [w["children"] for w in wins][:2] == [{"x.wait": 3}] * 2
    # 6 + 4 + 2 stamped ns over 10 + 20 + 4 of host cycle
    assert spans.idle(wins) == pytest.approx(1 - 12 / 34)
    parts = spans.windows(entries, [(0, 10), (30, 200)])
    assert [(w["t0"], w["cycle"]) for w in parts] == \
        [(0, 10), (10, None), (30, None), (100, 4), (104, None)]
    assert spans.idle(parts) == pytest.approx(1 - 8 / 14)
    assert spans.idle(spans.windows(entries[:3])) is None


def test_requests_time_from_their_call_start():
    with spans.span("serve.call") as call:
        for rid in range(3):
            spans.event("first_token", rid=rid, call=call.id)
        for rid in range(3):
            spans.event("finish", rid=rid, call=call.id)
    spans.event("finish", rid=9, call=None)     # no call: left out
    got = spans.requests(spans.records())
    (t0,) = [e["t0"] for e in _kinds("span", "serve.call")]
    want = {k: [e["t"] - t0 for e in _kinds("event", name)
                if e["call"] == call.id]
            for k, name in (("ttft", "first_token"), ("latency", "finish"))}
    assert got == want and len(got["ttft"]) == 3
    reqs = spans.summary()["requests_ms"]
    assert reqs["ttft"][0] == round(1e-6 * np.mean(want["ttft"]), 4)
    assert reqs["latency"][1] == \
        round(1e-6 * np.percentile(want["latency"], 95), 4)


def test_switched_off_records_nothing_and_stamps_nothing(monkeypatch):
    monkeypatch.setattr(spans, "ENABLED", False)
    with spans.span("a") as a:
        spans.event("e")
        with spans.program("p", "cpu") as prog:
            spans.stamp("x")
    assert a is None and prog is None
    _serve()
    assert spans.records() == [] and not spans._pending
    assert spans.counters == {"dropped": 0, "stamps_lost": 0,
                              "stamps_over": 0}


def test_stamps_outside_a_window_program_do_nothing():
    pcfg = pl.make_config(256, 4, sb_slots=16, page_slots=4, slack=1.5,
                          dtype="float32")
    eng = E.Engine(pcfg, E.EngineOptions(collect_every=2), device="cpu")
    state = eng.init()
    state, _, _ = eng.step(state, "alloc", np.arange(64), np.ones((64, 4)))
    state, _, _ = eng.step(state, "read", np.arange(8), do_collect=True)
    spans.stamp("x")
    assert spans.records() == [] and not spans._pending


def test_areas_wait_for_a_copy_up_to_a_bound(monkeypatch):
    monkeypatch.setattr(spans, "PENDING", 3)
    for i in range(5):
        with spans.program("p", "cpu", head=2) as prog:
            prog.payload.fill_(i)
            spans.stamp("x")
    assert spans.counters["stamps_lost"] == 2
    host = spans.fetch([torch.ones(3, dtype=torch.float64)])
    assert host.tolist() == [1.0, 1.0, 1.0]
    got = _kinds("stamps")
    assert len(got) == 3 and all(e["names"] == ("start", "x") for e in got)
    assert all(e["t"][0] <= e["t"][1] <= e["host_return"] for e in got)


def test_a_program_payload_shares_the_copy_with_its_stamps():
    with spans.program("p", "cpu", head=4) as prog:
        torch.cat([torch.arange(4.0, dtype=torch.float64)],
                  out=prog.payload)
        spans.stamp("a")
        spans.stamp("b")
    host = spans.fetch([prog.payload])
    assert host.tolist() == [0.0, 1.0, 2.0, 3.0]
    (e,) = _kinds("stamps")
    assert e["names"] == ("start", "a", "b") and e["program"] == "p"
    seg = spans.segments(e)
    assert sum(seg.values()) == e["t"][-1] - e["t"][0]
    assert list(seg) == ["a", "b"]


# -- the serve window -----------------------------------------------------
def _serve_names():
    layer = ["model", "kv.append", "attention", "kv.record"]
    names = ["start", "lanes"]
    for i in range(W):
        names += layer * LAYERS + ["model"] if i == 0 else ["step"]
        if (i + 1) % EVERY == 0:
            names += COLLECT
    return names + ["pack"]


def test_serve_windows_are_stamped_and_spanned():
    srv, results = _serve()
    (call,) = _kinds("span", "serve.call")
    wins = spans.windows(spans.records())
    assert len(wins) == len(srv.serve_log)
    assert [w["window"] for w in wins] == list(range(len(wins)))
    by_id = {e["id"]: e for e in _kinds("span")}
    for w in wins:
        assert w["name"] == "serve.window" and w["parent"] == call["id"]
        assert w["call"] == call["id"]
        assert list(w["children"]) == SERVE_CHILDREN
        kids = [e for e in by_id.values() if e["parent"] == w["id"]]
        assert all(w["t0"] <= k["t0"] <= k["t1"] <= w["t1"] for k in kids)
        st = w["stamps"]
        assert st["program"] == "serve" and st["names"] == tuple(
            _serve_names())
        t = st["t"]
        assert sum(spans.segments(st).values()) == t[-1] - t[0]
        assert all(np.diff(t) >= 0)
        # the CPU's device clock is the host's: the stamps lie inside the
        # launch, before the copy returns
        launch = next(k for k in kids if k["name"] == "serve.launch")
        assert launch["t0"] <= t[0] and t[-1] <= launch["t1"]
        assert t[-1] <= st["host_return"] <= w["t1"]
    assert len(_kinds("stamps")) == len(wins)
    for name in ("admit", "first_token", "finish"):
        got = sorted(e["rid"] for e in _kinds("event", name))
        assert got == list(range(len(results))), name
        assert all(e["call"] == call["id"] for e in _kinds("event", name))
    admitted = {e["rid"]: e["window"] for e in _kinds("event", "admit")}
    finished = {e["rid"]: e["window"] for e in _kinds("event", "finish")}
    for c in results:
        assert admitted[c.rid] == c.windows[0]
        assert finished[c.rid] == c.windows[1] - 1
    summary = spans.summary()
    assert summary["windows"] == len(wins)
    assert 0.0 <= summary["idle"] < 1.0
    assert set(summary["host_ms"]) == {"serve.window", "cycle",
                                       *SERVE_CHILDREN}
    assert len(summary["requests_ms"]["ttft"]) == 2
    assert summary["requests_ms"]["ttft"][0] <= \
        summary["requests_ms"]["latency"][0]
    assert set(summary["device_ms"]["serve"]) == set(_serve_names()[1:])


def test_serve_results_do_not_depend_on_the_switch(monkeypatch):
    srv, on = _serve()
    log, reports = list(srv.serve_log), list(srv.reports)
    monkeypatch.setattr(spans, "ENABLED", False)
    srv, off = _serve()
    assert [dataclasses.asdict(c) for c in on] == \
        [dataclasses.asdict(c) for c in off]
    assert repr(srv.serve_log) == repr(log)
    assert repr(srv.reports) == repr(reports)


def test_a_generate_window_brings_its_stamps_back_with_its_reports():
    m, params = _model()
    srv = Server(m, ServerConfig(batch=B, max_len=32, block_tokens=4,
                                 collect_every=EVERY))
    srv.generate(params, np.ones((B, 3), np.int32), max_new=EVERY + 2)
    got = _kinds("stamps")
    assert len(got) == 2 and {e["program"] for e in got} == {"window"}
    assert got[0]["names"][-1] == "pack" and not spans._pending


# -- the engine window ----------------------------------------------------
def _engine_run():
    pcfg = pl.make_config(512, 8, sb_slots=16, page_slots=4, slack=1.5,
                          dtype="float32")
    eng = E.Engine(pcfg, E.EngineOptions(
        collect_every=EVERY, backend=be.make("proactive")), device="cpu")
    state = eng.init()
    rng = np.random.default_rng(1)
    state, _, _ = eng.step(state, "alloc", np.arange(512),
                           rng.random((512, 8)).astype(np.float32))
    steps = [("read", rng.integers(0, 512, 32), None)] * (EVERY - 1) + \
        [("write", rng.integers(0, 512, 32), np.ones((32, 8)))]
    trace = E.make_trace(pcfg, steps * 3, device="cpu")
    _, outs, reps = eng.serve_steps(state, trace)
    return outs, reps


def test_engine_windows_are_stamped_and_spanned():
    _engine_run()
    wins = spans.windows(spans.records())
    assert [w["window"] for w in wins] == [0, 1, 2]
    names = ("start", "ops.read", "ops.write", *COLLECT, "pack")
    for w in wins:
        assert w["name"] == "engine.window"
        assert list(w["children"]) == ["engine.prepare", "engine.launch",
                                       "engine.wait", "engine.unpack"]
        st = w["stamps"]
        assert st["program"] == "engine" and st["names"] == names
        assert sum(spans.segments(st).values()) == st["t"][-1] - st["t"][0]
    assert len(_kinds("stamps")) == 3


def test_engine_results_do_not_depend_on_the_switch(monkeypatch):
    outs, reps = _engine_run()
    monkeypatch.setattr(spans, "ENABLED", False)
    outs_off, reps_off = _engine_run()
    assert torch.equal(outs, outs_off)
    assert repr(reps) == repr(reps_off) and len(reps) == 3
