"""The port's six tiering backends, their deprecated shims and the
collector's `compact_heap` against the JAX package, bit for bit.

Backends: several windows of synthetic superblock stats (the shape of
`tests/test_backend_parity.py`'s second suite), either drawn afresh each
window or with the tiers and evict states each window leaves carried into
the next; tiers, evict states, the carried `bstate` and the telemetry are
held exactly after every window, and the pressure backends must demote
(and `promote` promote). `BackendConfig`, `as_backend`, the `step` shim
and `pressure_params` agree with JAX on every name and reject unknown
ones. `compact_heap` runs on the cases of `tests/test_pool_collector.py`
(a fragmented NEW region; migrated HOT and COLD regions with interleaved
holes) and the pools agree before and after, and after the reads and
allocations that follow."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import backend as jbe
from repro.core import collector as jcol
from repro.core import object_table as jot
from repro.core import pool as jpl
from repro_torch.core import backend as tbe
from repro_torch.core import collector as tcol
from repro_torch.core import pool as tpl
from test_torch_pool import (assert_state_equal, jax_pool_config, run_both,
                             to_np)

ALL = ("null", "proactive", "reactive", "cap", "mglru", "promote")
SB = 4096
N_SBS, WINDOWS = 16, 12
# pressure that makes every backend with a target act on 16 superblocks
PARAMS = {
    "null": {}, "proactive": {},
    "reactive": dict(hbm_target_bytes=6 * SB),
    "cap": dict(hbm_target_bytes=6 * SB),
    "mglru": dict(hbm_target_bytes=6 * SB),
    "promote": dict(hbm_high_bytes=6 * SB, hbm_low_bytes=4 * SB,
                    promote_after=2),
}


def _stats(rng, n):
    """One window's superblock stats, signals and (tier, evict), numpy."""
    return ({"occupancy": rng.integers(0, 4, n).astype(np.int32),
             "referenced": rng.random(n) < 0.5,
             "region": rng.integers(0, 3, n).astype(np.int8),
             "tier": np.zeros(n, np.int8), "evict": np.zeros(n, np.int8)},
            rng.integers(0, 2, n).astype(np.int8),
            rng.integers(0, 3, n).astype(np.int8), bool(rng.random() < 0.5))


def _leaves_equal(j, t, what):
    """Two flat dicts of arrays: the same keys, dtypes and values."""
    assert sorted(j) == sorted(t), (what, sorted(j), sorted(t))
    for k in j:
        a, b = to_np(j[k]), to_np(t[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, k, a, b)


@pytest.mark.parametrize("mode", ["fresh", "carried"])
@pytest.mark.parametrize("name", ALL)
def test_backend_windows_bit_identical(name, mode):
    geom_j = jbe.PageGeometry(n_sbs=N_SBS, sb_bytes=SB)
    geom_t = tbe.PageGeometry(n_sbs=N_SBS, sb_bytes=SB)
    jb, tb = jbe.make(name, **PARAMS[name]), tbe.make(name, **PARAMS[name])
    jstep = jax.jit(lambda bs, st, ti, ev, sg: jb.step(geom_j, bs, st, ti,
                                                       ev, sg))
    jstate, tstate = jb.init(geom_j), tb.init(geom_t)
    _leaves_equal(jstate, tstate, "init")
    rng = np.random.default_rng(7)
    tier = evict = None
    demoted = promoted = 0
    for w in range(WINDOWS):
        stats, tier_w, evict_w, ok = _stats(rng, N_SBS)
        if mode == "fresh" or tier is None:
            tier, evict = tier_w, evict_w
        jout = jstep(jstate, jax.tree.map(jnp.asarray, stats),
                     jnp.asarray(tier), jnp.asarray(evict),
                     {"proactive_ok": jnp.asarray(ok),
                      "epoch": jnp.asarray(w, jnp.int32)})
        tout = tb.step(geom_t, tstate,
                       {k: torch.from_numpy(v) for k, v in stats.items()},
                       torch.from_numpy(tier), torch.from_numpy(evict),
                       {"proactive_ok": torch.tensor(ok),
                        "epoch": torch.tensor(w, dtype=torch.int32)})
        jstate, jt, je, jtel = jout
        tstate, tt, te, ttel = tout
        _leaves_equal(jstate, tstate, (name, w, "bstate"))
        _leaves_equal(jtel, ttel, (name, w, "telemetry"))
        assert to_np(tt).dtype == np.int8 and to_np(te).dtype == np.int8
        assert np.array_equal(to_np(jt), to_np(tt)), (name, w, "tier")
        assert np.array_equal(to_np(je), to_np(te)), (name, w, "evict")
        tier, evict = to_np(tt).copy(), to_np(te).copy()
        demoted += int(ttel["be_demoted"])
        promoted += int(ttel["be_promoted"])
    if name != "null":
        assert demoted > 0, f"{name} demoted nothing"
    if name == "promote":
        assert promoted > 0, "promote promoted nothing"
    else:
        assert promoted == 0


def test_registry_and_pressure_params_match():
    assert tbe.names() == jbe.names() == tuple(sorted(ALL))
    for name in ALL:
        for target in (0, 64, 5 * SB):
            assert tbe.pressure_params(name, target) == \
                jbe.pressure_params(name, target), (name, target)
    for mod in (tbe, jbe):
        with pytest.raises(ValueError):
            mod.pressure_params("bogus", 64)
        with pytest.raises(ValueError):
            mod.make("reactve")
        with pytest.raises(TypeError):
            mod.make("reactive", hbm_target=1)      # unknown param


def _same_backend(j, t):
    assert type(j).__name__ == type(t).__name__
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("kind", ALL)
def test_backend_config_and_as_backend_match(kind):
    for target in (0, 3 * SB):
        jc = jbe.BackendConfig(kind=kind, hbm_target_bytes=target)
        tc = tbe.BackendConfig(kind=kind, hbm_target_bytes=target)
        _same_backend(jc.build(), tc.build())
        _same_backend(jbe.as_backend(jc), tbe.as_backend(tc))
    _same_backend(jbe.as_backend(kind), tbe.as_backend(kind))
    b = tbe.make(kind, **PARAMS[kind])
    assert tbe.as_backend(b) is b
    for mod in (tbe, jbe):
        with pytest.raises(ValueError):
            mod.BackendConfig(kind="reactve")
        with pytest.raises(TypeError):
            mod.as_backend(3)


@pytest.mark.parametrize("kind", ALL)
def test_step_shim_matches(kind):
    """The deprecated stateless `step`: fresh state, epoch 0."""
    pcfg_t = tpl.make_config(256, 4, sb_slots=8, slack=1.0)
    pcfg_j = jax_pool_config(pcfg_t)
    rng = np.random.default_rng(11)
    for trial in range(6):
        target = int(rng.integers(0, pcfg_t.n_sbs + 4)) * pcfg_t.sb_bytes
        stats, tier, evict, ok = _stats(rng, pcfg_t.n_sbs)
        jt, je = jbe.step(jbe.BackendConfig(kind, target), pcfg_j,
                          jax.tree.map(jnp.asarray, stats),
                          jnp.asarray(tier), jnp.asarray(evict),
                          jnp.asarray(ok))
        tt, te = tbe.step(tbe.BackendConfig(kind, target), pcfg_t,
                          {k: torch.from_numpy(v) for k, v in stats.items()},
                          torch.from_numpy(tier), torch.from_numpy(evict),
                          torch.tensor(ok))
        assert np.array_equal(to_np(jt), to_np(tt)), (kind, trial)
        assert np.array_equal(to_np(je), to_np(te)), (kind, trial)


# ---------------------------------------------------------------------------
# compact_heap (the cases of tests/test_pool_collector.py)
# ---------------------------------------------------------------------------
CFG_T = tpl.make_config(64, 4, sb_slots=8, page_slots=4, slack=2.0)
CFG_J = jax_pool_config(CFG_T)
_jcollect = jax.jit(lambda s: jcol.collect(CFG_J, jcol.CollectorConfig(), s))
_jcompact = jax.jit(lambda s, heap: jcol.compact_heap(CFG_J, s, heap),
                    static_argnums=1)


def _alloc(n):
    vals = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return (tpl.OP_ALLOC, np.arange(n, dtype=np.int32), vals)


def _free(ids):
    ids = np.asarray(ids, np.int32)
    return (tpl.OP_FREE, ids, np.zeros((len(ids), 4), np.float32))


def _both_compact(jstate, tstate, heap):
    jstate = _jcompact(jstate, heap)
    tstate = tcol.compact_heap(CFG_T, tstate, heap)
    assert_state_equal(jstate, tstate)
    assert np.array_equal(
        to_np(tpl.recompute_sb_occupancy(CFG_T, tstate["slot_owner"])),
        to_np(jpl.recompute_sb_occupancy(CFG_J, jstate["slot_owner"])))
    lo, hi = CFG_T.region(heap)
    owner = to_np(tstate["slot_owner"])[lo:hi]
    nz = np.nonzero(owner >= 0)[0]
    assert len(nz) == 0 or nz.max() == len(nz) - 1, "region not dense"
    return jstate, tstate


def _after(jstate, tstate, keep, holes):
    """Reads of the survivors, then a re-allocation of the holes."""
    keep = np.asarray(keep, np.int32)
    trace = [(tpl.OP_READ, keep, np.zeros((len(keep), 4), np.float32)),
             (tpl.OP_ALLOC, np.asarray(holes, np.int32),
              np.full((len(holes), 4), 5.0, np.float32))]
    jstate, tstate, reads = run_both(CFG_T, trace, jstate, tstate)
    for jv, tv in reads:
        assert np.array_equal(jv, tv)
    vals = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    assert np.array_equal(reads[0][1], vals[keep])
    assert_state_equal(jstate, tstate)


def test_compact_heap_new_region_matches():
    holes = [1, 3, 5, 7, 9]
    jstate, tstate, _ = run_both(CFG_T, [_alloc(24), _free(holes)])
    jstate, tstate = _both_compact(jstate, tstate, jot.NEW)
    _after(jstate, tstate, [i for i in range(24) if i not in holes], holes)


@pytest.mark.parametrize("heap", [jot.HOT, jot.COLD])
def test_compact_heap_interleaved_holes_matches(heap):
    jstate, tstate, _ = run_both(CFG_T, [_alloc(32)])
    hot = np.arange(12, dtype=np.int32)
    for _ in range(6):
        jstate, tstate, _ = run_both(
            CFG_T, [(tpl.OP_READ, hot, np.zeros((12, 4), np.float32))],
            jstate, tstate)
        jstate, _ = _jcollect(jstate)
        tstate, _ = tcol.collect(CFG_T, tcol.CollectorConfig(), tstate)
        assert_state_equal(jstate, tstate)
    heaps = to_np(jot.heap_of(jstate["table"][:32]))
    assert (heaps[:12] == jot.HOT).all() and (heaps[12:] == jot.COLD).all()
    objs = list(range(12)) if heap == jot.HOT else list(range(12, 32))
    holes = objs[1::2]
    jstate, tstate, _ = run_both(CFG_T, [_free(holes)], jstate, tstate)
    jstate, tstate = _both_compact(jstate, tstate, heap)
    _after(jstate, tstate, [i for i in objs if i not in holes], holes)
