"""The port's CrestKV (`repro_torch.data.crestkv`) against the JAX
package's, exactly, with the SimHeap's backend on the CPU: every Table-1
structure under YCSB-A with tidying and `proactive`, and hash-pugh under
each of the six backends on YCSB-B and YCSB-C under a memory target. The
window logs, the run statistics, the value-id churn and the heap's
placement and page arrays must be equal. Then the JAX package's CrestKV
checks (`tests/test_data_and_sim.py`) on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.data import crestkv as jck
from repro.data.structures import STRUCTURES
from repro_torch.data import crestkv as tck

BACKENDS = ("reactive", "proactive", "cap", "null", "mglru", "promote")
HEAP_ARRAYS = ("addr", "size", "heap", "access", "ciw", "atc", "resident",
               "referenced", "evict")


def _pair(structure, n, seed=0, **sim):
    jkv = jck.CrestKV(structure, n, jck.default_sim_config(n, **sim),
                      seed=seed)
    tkv = tck.CrestKV(structure, n, tck.default_sim_config(n, **sim),
                      seed=seed, device="cpu")
    return jkv, tkv


def assert_runs_equal(jkv, tkv, js, ts):
    assert js.windows == ts.windows
    assert (js.ops, js.total_ns, js.base_ns, js.faults) == \
        (ts.ops, ts.total_ns, ts.base_ns, ts.faults)
    assert (js.throughput_mops, js.overhead_frac, js.mean_latency_ns) == \
        (ts.throughput_mops, ts.overhead_frac, ts.mean_latency_ns)
    assert np.array_equal(jkv.value_obj, tkv.value_obj)
    assert (jkv._free_ids, jkv._next_id) == (tkv._free_ids, tkv._next_id)
    jh, th = jkv.heap, tkv.heap
    assert jh.window_log == th.window_log
    for k in HEAP_ARRAYS:
        a, b = getattr(jh, k), getattr(th, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (jh.cursor, jh.live_bytes, jh.total_moves, jh.ciw_threshold,
            jh.epoch, jh.proactive_ok) == \
        (th.cursor, th.live_bytes, th.total_moves, th.ciw_threshold,
         th.epoch, th.proactive_ok)
    assert jh.rss_bytes() == th.rss_bytes()


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_structure_run_matches_jax(structure):
    """Table 1's run (YCSB-A, 12 ops a key, a window of 3 x keys) at 2,000
    keys, HADES with `proactive`."""
    n = 2000
    jkv, tkv = _pair(structure, n, backend="proactive", enabled=True)
    kw = dict(window_ops=3 * n, seed=1)
    js, ts = jkv.run("A", 12 * n, **kw), tkv.run("A", 12 * n, **kw)
    assert len(ts.windows) == 3
    assert_runs_equal(jkv, tkv, js, ts)


@pytest.mark.parametrize("workload", ["B", "C"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_run_matches_jax(backend, workload):
    """Fig 7's run (hash-pugh, 60 ops a key) at 2,000 keys, tidying on,
    under a target of 40 % of the load's footprint."""
    n = 2000
    jkv, tkv = _pair("hash-pugh", n, backend=backend, enabled=True,
                     hbm_target_bytes=int(0.4 * n * 1200))
    kw = dict(window_ops=3 * n, seed=1)
    js, ts = jkv.run(workload, 60 * n, **kw), tkv.run(workload, 60 * n, **kw)
    assert len(ts.windows) == 14
    assert_runs_equal(jkv, tkv, js, ts)
    if backend in ("cap", "reactive", "mglru"):
        assert ts.faults > 0, "the pressure backend never paged out"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the rule on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tck.CrestKV("hash-pugh", 64, tck.default_sim_config(64))


def test_crestkv_hades_beats_baseline():
    """The paper's headline at mini scale: tidying raises page
    utilization and cuts RSS with small overhead."""
    n = 20_000
    base = tck.CrestKV("hash-pugh", n,
                       tck.default_sim_config(n, backend="null",
                                              enabled=False),
                       seed=0, device="cpu")
    sb = base.run("C", 400_000, window_ops=80_000)
    hades = tck.CrestKV("hash-pugh", n,
                        tck.default_sim_config(n, backend="proactive",
                                               enabled=True),
                        seed=0, device="cpu")
    sh = hades.run("C", 400_000, window_ops=80_000)
    pu_base = sb.windows[-1]["page_utilization"]
    pu_hades = sh.windows[-1]["page_utilization"]
    assert pu_hades > 1.5 * pu_base
    assert sh.windows[-1]["rss_bytes"] < 0.7 * sb.windows[-1]["rss_bytes"]
    assert sh.overhead_frac < 0.10


def test_crestkv_updates_churn():
    n = 5_000
    kv = tck.CrestKV("btree-occ", n,
                     tck.default_sim_config(n, backend="reactive",
                                            hbm_target_bytes=1 << 22),
                     seed=0, device="cpu")
    st = kv.run("A", 100_000, window_ops=25_000)
    assert st.ops == 100_000
    assert len(st.windows) >= 3
