"""The port's object engine against the JAX package's, bit for bit:
`Engine.run_window` over `tests/test_engine.py`'s mixed read / write /
free / alloc traces from an aligned clock, under each of the six backends
at collect_every 1 and 4 with overlap_collect off and on, and once with
JAX's Pallas collector (interpret mode). Every leaf of the pool state, the
read outputs and the per-step reports must be identical. The unaligned
(generic) shape, `serve_steps`, `enabled=False`, odd ids, the per-op paths
and `make_trace` are in `tests/test_torch_engine_generic.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import backend as jbe
from repro.core import collector as jcol
from repro.core import engine as jeng
from repro_torch.core import backend as tbe
from repro_torch.core import collector as tcol
from repro_torch.core import engine as teng
from repro_torch.core import pool as tpl
from test_engine import _mixed_steps
from test_torch_pool import assert_state_equal, jax_pool_config

TCFG = tpl.make_config(max_objects=64, slot_words=8, sb_slots=8,
                       page_slots=4, slack=2.0)
JCFG = jax_pool_config(TCFG)
BACKENDS = ("null", "proactive", "reactive", "cap", "mglru", "promote")


def _params(name, sb_bytes):
    """Each backend under pressure: two superblocks' worth of target (for
    promote the high watermark, the low one at one superblock)."""
    if name == "promote":
        return dict(hbm_high_bytes=2 * sb_bytes, hbm_low_bytes=sb_bytes)
    return jbe.pressure_params(name, 2 * sb_bytes)


def options(name="proactive", every=4, overlap=False, enabled=True,
            use_pallas=False):
    """(JAX options, port options) with the same fields."""
    p = _params(name, TCFG.sb_bytes)
    jo = jeng.EngineOptions(
        collect_every=every, backend=jbe.make(name, **p),
        collector=jcol.CollectorConfig(use_pallas=use_pallas),
        enabled=enabled, overlap_collect=overlap)
    to = teng.EngineOptions(
        collect_every=every, backend=tbe.make(name, **p),
        collector=tcol.CollectorConfig(), enabled=enabled,
        overlap_collect=overlap)
    return jo, to


def assert_reports_equal(jrep, trep):
    """Per-step reports {key: [T]}: the same keys, dtypes and values."""
    assert sorted(jrep) == sorted(trep)
    for k in jrep:
        a, b = np.asarray(jrep[k]), trep[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (k, a, b)


def run_both(jo, to, steps, step0=0, jstate=None, tstate=None):
    """The same trace through both engines. Returns the JAX and the port
    (state, outs, reports)."""
    je, te = jeng.Engine(JCFG, jo), teng.Engine(TCFG, to, device="cpu")
    jtrace = jeng.make_trace(JCFG, steps)
    ttrace = teng.make_trace(TCFG, steps, device="cpu")
    j = je.run_window(je.init() if jstate is None else jstate, jtrace, step0)
    t = te.run_window(te.init() if tstate is None else tstate, ttrace, step0)
    return j, t


def assert_runs_equal(j, t):
    assert_state_equal(j[0], t[0])
    assert np.array_equal(np.asarray(j[1]), t[1].numpy())
    assert_reports_equal(j[2], t[2])
    assert jeng.window_reports(j[2]) == teng.window_reports(t[2])


# every backend at (every 4, no overlap) and (every 1, overlap); the other
# two pairs once each
CASES = [(b, 4, False) for b in BACKENDS] + [(b, 1, True) for b in BACKENDS] \
    + [("promote", 4, True), ("cap", 1, False)]


@pytest.mark.parametrize("backend,every,overlap", CASES)
def test_run_window_matches_jax(backend, every, overlap):
    steps = _mixed_steps(np.random.default_rng(0))
    j, t = run_both(*options(backend, every, overlap), steps)
    assert_runs_equal(j, t)
    reps = teng.window_reports(t[2])
    assert len(reps) == len(steps) // every
    assert sum(r["moved_to_hot"] + r["moved_to_cold"] for r in reps) > 0
    if backend not in ("null", "proactive"):
        assert sum(r["be_demoted"] for r in reps) > 0
    if backend in ("mglru", "promote"):
        assert t[0]["bstate"]


def test_run_window_matches_jax_pallas_collector():
    """JAX's Pallas collector (access_scan and migrate in interpret mode),
    which its tests hold bit-identical to its plain path."""
    steps = _mixed_steps(np.random.default_rng(1), n_steps=7)
    j, t = run_both(*options("proactive", 4, use_pallas=True), steps)
    assert_runs_equal(j, t)
