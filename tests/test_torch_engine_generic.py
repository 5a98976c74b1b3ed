"""The port's object engine against the JAX package's, bit for bit, beyond
the aligned windows of `tests/test_torch_engine.py`: the generic shape
(an unaligned `step0` or T, a non-int `step0`), chained calls,
`serve_steps` (the empty trace too), `enabled=False`, ids out of range or
repeated within a step, and `make_trace`. Then the port against itself:
its per-op paths (`Hades`, `Engine.step`) equal its fused path, and an
aligned window holds no op that a CUDA graph capture cannot hold."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import engine as jeng
from repro_torch.core import Hades as THades
from repro_torch.core import engine as teng
from test_engine import _mixed_steps
from test_torch_engine import (JCFG, TCFG, assert_reports_equal,
                               assert_runs_equal, options, run_both)
from test_torch_pool import assert_state_equal
from test_torch_window import _CaptureBlockers


@pytest.mark.parametrize("backend,overlap,step0,t", [
    ("proactive", False, 2, 16), ("mglru", True, 3, 16),
    ("promote", True, 0, 10), ("reactive", False, np.int32(0), 16)])
def test_generic_shape_matches_jax(backend, overlap, step0, t):
    """An unaligned clock or length, or a step0 that is not an int, takes
    the generic shape in both packages."""
    steps = _mixed_steps(np.random.default_rng(2))[:t]
    j, tt = run_both(*options(backend, 4, overlap), steps, step0=step0)
    assert_runs_equal(j, tt)


def test_chained_calls_match_jax_and_one_call():
    """An aligned window, then the rest of the trace from its clock."""
    steps = _mixed_steps(np.random.default_rng(3))
    jo, to = options("mglru", 4, True)
    j1, t1 = run_both(jo, to, steps[:8])
    j2, t2 = run_both(jo, to, steps[8:], step0=8, jstate=j1[0],
                      tstate=t1[0])
    assert_runs_equal(j2, t2)
    te = teng.Engine(TCFG, to, device="cpu")
    t_all = te.run_window(te.init(),
                          teng.make_trace(TCFG, steps, device="cpu"), 0)
    assert_state_equal(t_all[0], t2[0])
    assert torch.equal(t_all[1][8:, :t2[1].shape[1]], t2[1])


@pytest.mark.parametrize("n_steps", [15, 0])
def test_serve_steps_matches_jax(n_steps):
    steps = _mixed_steps(np.random.default_rng(4), n_steps=n_steps)
    steps = steps if n_steps else []
    jo, to = options("promote", 4, False)
    je, te = jeng.Engine(JCFG, jo), teng.Engine(TCFG, to, device="cpu")
    js, jo_, jr = je.serve_steps(je.init(), jeng.make_trace(JCFG, steps))
    ts, to_, tr = te.serve_steps(te.init(),
                                 teng.make_trace(TCFG, steps, device="cpu"))
    assert_state_equal(js, ts)
    assert np.asarray(jo_).shape == tuple(to_.shape)
    assert np.array_equal(np.asarray(jo_), to_.numpy())
    assert jr == tr and len(tr) == len(steps) // 4


def test_enabled_false_matches_jax():
    steps = _mixed_steps(np.random.default_rng(5))
    j, t = run_both(*options("reactive", 4, enabled=False), steps)
    assert_runs_equal(j, t)
    assert not t[2]["did_collect"].any() and int(t[0]["epoch"]) == 0


def test_odd_ids_match_jax():
    """Ids past the table clamp to its last word (XLA's gather), ids < 0
    are padding, and ids repeat within a step; under every op."""
    n = JCFG.max_objects
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(n, JCFG.slot_words)).astype(np.float32)
    odd = np.asarray([n, n + 5, 1 << 20, -1, 3, 3, n - 1, 7], np.int64)
    steps = [("alloc", np.arange(n - 8), vals[:n - 8]),
             ("read", odd, None),
             ("write", odd, rng.normal(size=(8, JCFG.slot_words))),
             ("read", odd, None),
             ("alloc", odd, rng.normal(size=(8, JCFG.slot_words))),
             ("read", np.arange(n), None),
             ("free", odd, None),
             ("read", np.arange(n), None)]
    j, t = run_both(*options("proactive", 4, False), steps)
    assert_runs_equal(j, t)


def test_make_trace_matches_jax():
    steps = _mixed_steps(np.random.default_rng(7))
    for k in (None, 60):
        jt = jeng.make_trace(JCFG, steps, k=k)
        tt = teng.make_trace(TCFG, steps, k=k, device="cpu")
        assert tt["op"].device.type == "cpu"
        for key in ("op", "ids", "values"):
            a, b = np.asarray(jt[key]), tt[key].numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), key
    with pytest.raises(AssertionError):
        teng.make_trace(TCFG, steps, k=5, device="cpu")
    tt["op"] = tt["op"].to("meta")
    te = teng.Engine(TCFG, options()[1], device="cpu")
    with pytest.raises(ValueError):
        te.run_window(te.init(), tt, 0)


@pytest.mark.parametrize("backend,every,overlap", [
    ("proactive", 4, False), ("mglru", 4, True), ("promote", 1, True)])
def test_per_op_paths_match_fused(backend, every, overlap):
    """`Hades` and an `Engine.step` loop against one `run_window` call: the
    state, the read outputs and the last report, bit for bit."""
    steps = _mixed_steps(np.random.default_rng(8))
    to = options(backend, every, overlap)[1]
    te = teng.Engine(TCFG, to, device="cpu")
    fused = te.run_window(te.init(),
                          teng.make_trace(TCFG, steps, device="cpu"), 0)
    h = THades(TCFG, to, device="cpu")
    state, outs = te.init(), []
    for i, (op, ids, values) in enumerate(steps):
        clock = i + 1
        state, out, rep = te.step(
            state, op, ids, values,
            do_arm=overlap and clock % every == every - 1,
            do_collect=clock % every == 0)
        if op == "read":
            got = getattr(h, op)(ids)
            assert torch.equal(got, out)
            outs.append((i, out))
        elif values is None:
            getattr(h, op)(ids)
        else:
            getattr(h, op)(ids, values)
    assert_state_equal(fused[0], state)
    assert_state_equal(fused[0], h.state)
    for i, out in outs:
        assert torch.equal(fused[1][i, :out.shape[0]], out)
    last = {k: v[len(steps) - 1] for k, v in fused[2].items()}
    assert_reports_equal({k: v.numpy() for k, v in last.items()},
                         {k: h.last_report[k] for k in last})
    assert_reports_equal({k: v.numpy() for k, v in last.items()}, rep)


def test_aligned_window_is_capture_safe():
    """The ops of an aligned engine window (reads, writes, allocs, frees
    and the collect, overlap on) under a mode that raises on any op a CUDA
    graph capture cannot hold (a host read, a data-dependent shape)."""
    steps = _mixed_steps(np.random.default_rng(9), n_steps=11)
    to = options("promote", 4, True)[1]
    te = teng.Engine(TCFG, to, device="cpu")
    trace = teng.make_trace(TCFG, steps, device="cpu")
    state = te.run_window(te.init(), {k: v[:4] for k, v in trace.items()},
                          0)[0]
    mode = _CaptureBlockers()
    ops = trace["op"].tolist()
    with mode:
        for lo in (4, 8):
            state, _, rep = te._run._steps(
                state, ops[lo:lo + 4], trace["ids"][lo:lo + 4],
                trace["values"][lo:lo + 4], 0)
    assert mode.seen["aten::sort"] > 0 and mode.seen["aten::index_put_"] > 0
    assert rep["did_collect"][-1]
