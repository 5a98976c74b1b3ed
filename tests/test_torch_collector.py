"""The port's collector, MIAD and backends against the JAX package, bit
for bit: pool state and every window-report field after collect +
backend windows with each of the six backends, including move_budget
deferral and an ATC-armed window. `cap`, `mglru` and `promote` also see
writes and a window that pages every other superblock out (a store to a
HOST superblock leaves it there, referenced, which is what `promote`
promotes); each must demote, and `promote` promote. Also the plain
versions of the `access_scan` and `migrate` kernels against the JAX
kernels (Pallas, interpret mode), including a migration where a cold
mover's destination is a hot mover's source."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import backend as jbe
from repro.core import collector as jcol
from repro.core import engine as jeng
from repro.core import object_table as jot
from repro.kernels import ops as jops
from repro_torch.core import backend as tbe
from repro_torch.core import collector as tcol
from repro_torch.core import engine as teng
from repro_torch.core import pool as tpl
from repro_torch.kernels import ref as tref
from test_torch_pool import (assert_state_equal, jax_pool_config, run_both,
                             to_np)


def _reads(rng, hot, n):
    """A read batch over the hot set, with padding (-1) mixed in."""
    ids = np.where(rng.random(n) < 0.8, rng.choice(hot, n), -1)
    return (tpl.OP_READ, ids.astype(np.int32), np.zeros((n, 8), np.float32))


# the backends ported with the window graphs: their traces add writes
WRITES = ("cap", "mglru", "promote")


@pytest.mark.parametrize("backend,budget", [
    ("null", 2), ("proactive", 2), ("reactive", 2), ("proactive", 256),
    ("reactive", 256), ("cap", 2), ("cap", 256), ("mglru", 256),
    ("promote", 256)])
def test_collect_windows_bit_identical(backend, budget):
    rng = np.random.default_rng(3)
    cfg_t = tpl.make_config(48, 8, sb_slots=4, page_slots=2)
    cfg_j = jax_pool_config(cfg_t)
    params = tbe.pressure_params(backend, 3 * cfg_t.sb_bytes)
    assert params == jbe.pressure_params(backend, 3 * cfg_t.sb_bytes)
    if backend == "promote":
        # high above the three superblocks the hot set keeps resident, so
        # that a referenced HOST superblock has room to return, and low at
        # them, so that promotion re-arms
        params = dict(hbm_high_bytes=4 * cfg_t.sb_bytes,
                      hbm_low_bytes=3 * cfg_t.sb_bytes)
    jb, tb = jbe.make(backend, **params), tbe.make(backend, **params)
    jcab = jax.jit(functools.partial(
        jeng.collect_and_backend, cfg_j,
        jcol.CollectorConfig(move_budget=budget), jb))
    tcol_cfg = tcol.CollectorConfig(move_budget=budget)

    ids = np.arange(20, dtype=np.int32)
    alloc = [(tpl.OP_ALLOC, ids,
              rng.normal(size=(20, 8)).astype(np.float32))]
    jstate, tstate, _ = run_both(cfg_t, alloc)
    # the backends' carried state rides the pool state, as kvcache.init sets
    jstate = dict(jstate, bstate=jb.init(cfg_j))
    tstate = dict(tstate, bstate=tb.init(cfg_t))
    hot = rng.choice(20, 6, replace=False)
    hot_moves, cold_moves, skipped = [], [], 0
    demoted = promoted = 0
    for window in range(9):
        if window == 4:                  # an ATC-armed window
            jstate, tstate = jcol.arm(jstate), tcol.arm(tstate)
        if window == 5 and backend in WRITES:
            # every other superblock paged out: the written ones stay on
            # HOST, referenced; the hot set's fault back in
            tier = to_np(tstate["sb_tier"]).copy()
            evict = to_np(tstate["sb_evict"]).copy()
            tier[::2], evict[::2] = tpl.HOST, tpl.PAGED_OUT
            jstate = dict(jstate, sb_tier=jnp.asarray(tier),
                          sb_evict=jnp.asarray(evict))
            tstate = dict(tstate, sb_tier=torch.from_numpy(tier),
                          sb_evict=torch.from_numpy(evict))
        trace = [_reads(rng, hot, 8) for _ in range(3)]
        if window == 2:                  # churn: free some, allocate anew
            trace.append((tpl.OP_FREE, ids[12:18], np.zeros((6, 8),
                                                             np.float32)))
            trace.append((tpl.OP_ALLOC, np.arange(42, 46, dtype=np.int32),
                          rng.normal(size=(4, 8)).astype(np.float32)))
        if backend in WRITES:
            trace.append((tpl.OP_WRITE, ids,
                          rng.normal(size=(20, 8)).astype(np.float32)))
        jstate, tstate, reads = run_both(cfg_t, trace, jstate, tstate)
        for jv, tv in reads:
            assert np.array_equal(jv, tv)
        jstate, jrep = jcab(jstate)
        tstate, trep = teng.collect_and_backend(cfg_t, tcol_cfg, tb, tstate)
        jr = jeng.window_reports({k: v[None] for k, v in jrep.items()})[0]
        tr = teng.window_reports([trep])[0]
        assert jr == tr, (window, jr, tr)
        assert_state_equal(jstate, tstate)
        hot_moves.append(tr["moved_to_hot"])
        cold_moves.append(tr["moved_to_cold"])
        skipped += tr["skipped_atc"]
        demoted += tr["be_demoted"]
        promoted += tr["be_promoted"]
    assert skipped > 0, "the armed window vetoed no migration"
    if backend in WRITES:
        assert demoted > 0, f"{backend} demoted nothing"
        assert (promoted > 0) == (backend == "promote"), promoted
    if budget == 2:
        # the budget saturates and defers movers to later windows
        assert max(hot_moves) == 2 and sum(hot_moves) > 2
    else:
        assert sum(hot_moves) > 2 and sum(cold_moves) > 0
    assert sorted(teng.zero_report()) == sorted(jeng.zero_report())


# ---------------------------------------------------------------------------
# kernel plain versions vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------
def _table(rng, n, n_slots):
    return [rng.integers(0, n_slots, n), rng.integers(0, 4, n),
            rng.integers(0, 2, n), rng.integers(0, 3, n),
            rng.integers(0, 32, n)]


@pytest.mark.parametrize("n,sb_slots,n_sbs", [(128, 8, 16), (300, 16, 64),
                                              (256, 32, 8)])
@pytest.mark.parametrize("ct", [0.0, 2.5, 30.0])
@pytest.mark.parametrize("with_hist", [True, False])
def test_access_scan_plain_matches_pallas(n, sb_slots, n_sbs, ct, with_hist):
    rng = np.random.default_rng(n + int(ct))
    f = _table(rng, n, sb_slots * n_sbs + 5)      # some slots past n_sbs
    jw = jot.pack(*[jnp.asarray(a, jnp.uint32) for a in f])
    tw = torch.from_numpy(to_np(jw).copy())
    got = tref.access_scan(tw, torch.tensor(ct, dtype=torch.float32),
                           sb_slots=sb_slots, n_sbs=n_sbs,
                           with_hist=with_hist)
    want = jops.access_scan(jw, jnp.asarray(ct, jnp.float32),
                            sb_slots=sb_slots, n_sbs=n_sbs,
                            with_hist=with_hist)
    for g, w in zip(got, want):
        assert np.array_equal(to_np(g), to_np(w))


@pytest.mark.parametrize("n,n_sbs", [(1, 0), (3, 1), (7168, 672),
                                     (1027, 100), (1 << 20, 65536)])
def test_access_scan_layout(n, n_sbs):
    """`ops._scan_layout`: the five outputs of a call lie in one buffer,
    each at a 16-byte-aligned offset, in disjoint ranges that fit it."""
    from repro_torch.kernels import ops as tops
    offsets, size = tops._scan_layout(n, n_sbs)
    sizes = dict(new_table=4 * n, hist=4 * n_sbs, skipped=4, to_hot=n,
                 to_cold=n)
    assert sorted(offsets) == sorted(sizes)
    spans = sorted((offsets[k], offsets[k] + sizes[k]) for k in sizes)
    assert all(a % 16 == 0 for a, _ in spans)
    assert all(e <= a2 for (_, e), (a2, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= size < spans[-1][1] + 16
    assert size - sum(sizes.values()) < 16 * len(sizes)
    outs = tops._scan_outputs(n, n_sbs, torch.device("cpu"))
    assert [(tuple(x.shape), x.dtype) for x in outs] == [
        ((n,), torch.int32), ((n,), torch.bool), ((n,), torch.bool),
        ((n_sbs,), torch.int32), ((), torch.int32)]
    base = outs[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in outs)
    assert all((x.data_ptr() - base) % 16 == 0 for x in outs)
    for i, x in enumerate(outs):           # each view is its own range
        x.fill_(i + 1)
    for i, x in enumerate(outs):
        assert bool((x == i + 1).all()) if x.dtype != torch.bool \
            else bool(x.all())


def _migrate_case(rng, n_rows, w, src, dst, ok):
    data = rng.normal(size=(n_rows, w)).astype(np.float32)
    data[-1] = 0.0                                  # the scratch row
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    ok = np.asarray(ok, bool)
    want = jops.migrate(jnp.asarray(data), jnp.asarray(src),
                        jnp.asarray(dst), jnp.asarray(ok),
                        has_scratch_row=True)
    got = tref.migrate(torch.from_numpy(data.copy()), torch.from_numpy(src),
                       torch.from_numpy(dst), torch.from_numpy(ok))
    assert np.array_equal(to_np(got), np.asarray(want))
    assert not to_np(got)[-1].any(), "scratch row must stay zero"
    return data, to_np(got)


def test_migrate_plain_matches_pallas_with_cold_into_vacated_hot_source():
    """Hot moves first, then cold moves that land in slots the hot moves
    just vacated: every move must read its source's value from BEFORE the
    migration (the sequential-grid contract of the TPU kernel)."""
    rng = np.random.default_rng(11)
    # hot: 3 -> 12, 5 -> 13 ; cold: 7 -> 3 (3 was a hot source), 9 -> 5;
    # masked entries point anywhere, including live slots
    data, got = _migrate_case(
        rng, 17, 24, src=[3, 5, 0, 7, 9, 4], dst=[12, 13, 1, 3, 5, 2],
        ok=[1, 1, 0, 1, 1, 0])
    assert np.array_equal(got[12], data[3]) and np.array_equal(got[3], data[7])
    assert np.array_equal(got[5], data[9]) and np.array_equal(got[1], data[1])


@pytest.mark.parametrize("n_rows,w", [(33, 8), (65, 128), (41, 96)])
def test_migrate_plain_matches_pallas_sweep(n_rows, w):
    rng = np.random.default_rng(n_rows)
    n_moves = (n_rows - 1) // 4
    src = rng.choice((n_rows - 1) // 2, n_moves, replace=False)
    dst = (n_rows - 1) // 2 + rng.choice((n_rows - 1) // 2, n_moves,
                                         replace=False)
    _migrate_case(rng, n_rows, w, src, dst, rng.random(n_moves) < 0.7)
