"""The port's `SimHeap` against the JAX package's, exactly: the
`tests/test_backend_parity.py` scenarios (pressure, calm, fragmented)
under each of the six backends, with tidying on and off — window logs,
addresses, heaps, residency and evict states after every window. Then
`tests/test_simheap_properties.py`'s invariants on the port under
hypothesis, and the port's `ZipfianKeys` and `WORKLOADS` yielding the JAX
package's streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
pytest.importorskip("hypothesis")  # optional dev dep (requirements-dev.txt)
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.simheap import SimConfig as JSimConfig
from repro.core.simheap import SimHeap as JSimHeap
from repro.data import ycsb as jycsb
from repro_torch.core.simheap import ALIGN, SimConfig, SimHeap
from repro_torch.data import ycsb as tycsb

BACKENDS = ("reactive", "proactive", "cap", "null", "mglru", "promote")


def _drive(h, scenario: str, seed: int = 0):
    """test_backend_parity.py's `_drive`: alloc 160 objects, then 8 windows
    of accesses, arm, collect and backend step. Yields after each
    window."""
    rng = np.random.default_rng(seed)
    n = 160
    h.alloc(np.arange(n), rng.integers(64, 2048, n))
    for w in range(8):
        if scenario == "pressure":
            hot = rng.integers(0, n // 8, 24)
        elif scenario == "calm":
            hot = rng.integers(0, n, 96)
        else:
            hot = (rng.integers(0, n // 2, 24) * 2) % n
            if w == 2:
                dead = [i for i in range(1, n, 3) if h.heap[i] >= 0]
                h.free(np.asarray(dead))
        live = hot[h.heap[hot] >= 0]
        if len(live):
            h.access_objects(live)
        h.arm()
        h.collect()
        h.backend_step()
        yield w


def _pages(h):
    return {k: getattr(h, k).copy() for k in ("addr", "heap", "size",
                                               "resident", "evict",
                                               "referenced", "ciw")}


def assert_heaps_equal(jh, th):
    assert jh.window_log == th.window_log
    for k, a in _pages(jh).items():
        b = getattr(th, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (jh.cursor, jh.live_bytes, jh.total_faults, jh.total_moves,
            jh.total_ns, jh.ciw_threshold, jh.epoch) == \
        (th.cursor, th.live_bytes, th.total_faults, th.total_moves,
         th.total_ns, th.ciw_threshold, th.epoch)
    assert jh.rss_bytes() == th.rss_bytes()
    assert jh.page_utilization() == th.page_utilization()
    assert np.array_equal(jh.per_page_utilization(), th.per_page_utilization())


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("scenario", ["pressure", "calm", "fragmented"])
@pytest.mark.parametrize("name", BACKENDS)
def test_simheap_matches_jax(name, scenario, enabled):
    kw = dict(max_objects=512, heap_bytes=1 << 19, backend=name,
              hbm_target_bytes=1 << 16 if scenario == "pressure"
              else 1 << 18, enabled=enabled)
    jh = JSimHeap(JSimConfig(**kw), seed=0)
    th = SimHeap(SimConfig(**kw), seed=0, device="cpu")
    for _ in zip(_drive(jh, scenario), _drive(th, scenario)):
        assert_heaps_equal(jh, th)
    stats_j, tier_j, evict_j = jh.page_stats()
    stats_t, tier_t, evict_t = th.page_stats()
    assert all(np.array_equal(stats_j[k], stats_t[k]) for k in stats_j)
    assert np.array_equal(tier_j, tier_t) and np.array_equal(evict_j, evict_t)
    if name not in ("null", "proactive") and scenario == "pressure":
        assert (th.evict == 2).any(), "the backend never paged out"


ops = st.lists(
    st.one_of(
        st.tuples(st.just("alloc"), st.integers(1, 20),
                  st.integers(16, 2048)),
        st.tuples(st.just("access"), st.integers(0, 199)),
        st.tuples(st.just("free"), st.integers(0, 199)),
        st.tuples(st.just("collect"), st.just(0)),
        st.tuples(st.just("backend"), st.just(0)),
    ), min_size=5, max_size=40)


def check_no_overlap(h: SimHeap):
    live = np.nonzero(h.heap >= 0)[0]
    if len(live) == 0:
        return
    order = np.argsort(h.addr[live])
    a = h.addr[live][order]
    sz = (h.size[live][order] + ALIGN - 1) // ALIGN * ALIGN
    assert (a[1:] >= a[:-1] + sz[:-1]).all(), "live objects overlap"
    for i in live:
        base = h.base[int(h.heap[i])]
        assert base <= h.addr[i] < base + h.cfg.heap_bytes
        assert h.addr[i] + h.size[i] <= base + h.cfg.heap_bytes


@settings(max_examples=30, deadline=None)
@given(ops, st.sampled_from(["reactive", "proactive", "cap", "null",
                             "mglru", "promote"]))
def test_simheap_invariants_any_interleaving(op_list, backend):
    """test_simheap_properties.py's invariants on the port (all six
    backends)."""
    cfg = SimConfig(max_objects=256, heap_bytes=1 << 20, backend=backend,
                    hbm_target_bytes=1 << 18)
    h = SimHeap(cfg, seed=0, device="cpu")
    next_id = 0
    live_ids = set()
    for op in op_list:
        if op[0] == "alloc":
            _, n, size = op
            n = min(n, 256 - next_id)
            if n <= 0:
                continue
            ids = np.arange(next_id, next_id + n)
            h.alloc(ids, np.full(n, size))
            live_ids.update(ids.tolist())
            next_id += n
        elif op[0] == "access":
            pick = [i for i in (op[1], op[1] // 2) if i in live_ids]
            if pick:
                h.access_objects(np.asarray(pick))
        elif op[0] == "free":
            if op[1] in live_ids:
                h.free(np.asarray([op[1]]))
                live_ids.discard(op[1])
        elif op[0] == "collect":
            rep = h.collect()
            assert 0 <= rep["promotion_rate"] <= 1
            assert 0 < rep["page_utilization"] <= 1
            assert cfg.ciw_min <= h.ciw_threshold <= cfg.ciw_max
        elif op[0] == "backend":
            h.backend_step()
        check_no_overlap(h)
    assert 0 <= h.rss_bytes() <= 3 * cfg.heap_bytes + 2 * (1 << 21)
    assert all(v >= 0 for v in h.live_bytes.values())


def test_emergency_compact_charges_faults():
    """Compacting a region with paged-out pages faults them in."""
    cfg = SimConfig(max_objects=64, heap_bytes=1 << 16, backend="proactive")
    h = SimHeap(cfg, seed=0, device="cpu")
    h.alloc(np.arange(32), np.full(32, 1024))
    for _ in range(6):
        h.collect()
        h.backend_step()
    assert (h.evict == 2).any()
    before = h.total_faults
    h._compact(2)
    assert h.total_faults > before


@pytest.mark.parametrize("active_frac", [1.0, 1 / 3])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_zipfian_keys_match_jax(seed, active_frac):
    jk = jycsb.ZipfianKeys(10007, seed=seed, active_frac=active_frac)
    tk = tycsb.ZipfianKeys(10007, seed=seed, active_frac=active_frac)
    assert np.array_equal(jk.scramble, tk.scramble)
    for k in (1, 4096, 333):
        assert np.array_equal(jk.sample(k), tk.sample(k))
    assert np.array_equal(jk.hot_set(0.5), tk.hot_set(0.5))
    assert {k: (v.read_frac, v.update_frac)
            for k, v in jycsb.WORKLOADS.items()} == \
        {k: (v.read_frac, v.update_frac) for k, v in tycsb.WORKLOADS.items()}
