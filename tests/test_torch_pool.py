"""The port's object table and pool against the JAX package, bit for bit:
packed table words (compared as int32), slot owners, free rings,
occupancy, referenced bits, tiers and counters after random
alloc/read/write/free traces. Inputs come from numpy seeds and go
through both packages. Also holds the helpers the other
`test_torch_*` files share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import object_table as jot
from repro.core import pool as jpl
from repro_torch.core import object_table as tot
from repro_torch.core import pool as tpl


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def to_np(x):
    """A JAX or torch leaf as numpy; 32-bit table words as int32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def assert_state_equal(jstate, tstate, *, skip=(), data_tol=None):
    """Every leaf equal (integer/bool leaves bit for bit; `data` within
    `data_tol` when given)."""
    fj, ft = flat(jstate), flat(tstate)
    assert sorted(fj) == sorted(ft), (sorted(fj), sorted(ft))
    for k in fj:
        if any(k.endswith(s) for s in skip):
            continue
        a, b = to_np(fj[k]), to_np(ft[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if data_tol is not None and k.endswith("data"):
            assert np.abs(a.astype(np.float64) - b).max() <= data_tol, k
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"{k} differs: {a} vs {b}"


def jax_pool_config(tcfg):
    return jpl.PoolConfig(**{f: getattr(tcfg, f) for f in (
        "max_objects", "slot_words", "sb_slots", "page_slots", "new_sbs",
        "hot_sbs", "cold_sbs", "dtype", "word_bytes")})


def random_trace(rng, n_ops, max_objects, k, slot_words):
    """[(op, ids [k] int32, values [k, W] float32)] with padding (-1),
    duplicates and dead ids mixed in."""
    ops = []
    for i in range(n_ops):
        op = tpl.OP_ALLOC if i < 3 else int(rng.choice(
            [tpl.OP_READ, tpl.OP_WRITE, tpl.OP_ALLOC, tpl.OP_FREE],
            p=[0.35, 0.2, 0.3, 0.15]))
        ids = rng.integers(-1, max_objects, k).astype(np.int32)
        if rng.random() < 0.5:
            ids[rng.integers(0, k)] = ids[0]          # in-batch duplicate
        vals = rng.normal(size=(k, slot_words)).astype(np.float32)
        ops.append((op, ids, vals))
    return ops


_japply = jax.jit(jpl.apply_op, static_argnums=(0, 2))


def run_both(cfg_t, trace, jstate=None, tstate=None):
    """Apply the trace to both pools; returns (jstate, tstate, reads)."""
    cfg_j = jax_pool_config(cfg_t)
    jstate = jpl.init(cfg_j) if jstate is None else jstate
    tstate = tpl.init(cfg_t) if tstate is None else tstate
    reads = []
    for op, ids, vals in trace:
        jstate, jv = _japply(cfg_j, jstate, op, jnp.asarray(ids),
                             jnp.asarray(vals))
        tstate, tv = tpl.apply_op(cfg_t, tstate, op, torch.from_numpy(ids),
                                  torch.from_numpy(vals))
        reads.append((np.asarray(jv), tv.numpy()))
    return jstate, tstate, reads


# ---------------------------------------------------------------------------
# object table
# ---------------------------------------------------------------------------
def _fields(rng, n):
    return [rng.integers(0, hi, n) for hi in
            (jot.MAX_SLOTS, 4, 2, jot.ATC_SAT + 1, jot.CIW_SAT + 1)]


def test_pack_and_fields_match_bitwise():
    rng = np.random.default_rng(0)
    f = _fields(rng, 512)
    jw = jot.pack(*[jnp.asarray(a, jnp.uint32) for a in f])
    tw = tot.pack(*[torch.from_numpy(a.astype(np.int32)) for a in f])
    assert np.array_equal(to_np(jw), to_np(tw))
    for jf, tf in [(jot.slot_of, tot.slot_of), (jot.heap_of, tot.heap_of),
                   (jot.access_of, tot.access_of), (jot.atc_of, tot.atc_of),
                   (jot.ciw_of, tot.ciw_of)]:
        assert np.array_equal(np.asarray(jf(jw)).astype(np.int64),
                              to_np(tf(tw)).astype(np.int64))
    # CIW >= 16 sets the sign bit of the int32 carrier: fields still mask
    assert (to_np(tw) < 0).any()
    new = rng.integers(0, 32, 512)
    for jf, tf in [(jot.with_ciw, tot.with_ciw), (jot.with_atc, tot.with_atc),
                   (jot.with_slot, tot.with_slot),
                   (jot.with_heap, tot.with_heap),
                   (jot.with_access, tot.with_access)]:
        assert np.array_equal(
            to_np(jf(jw, jnp.asarray(new, jnp.uint32))),
            to_np(tf(tw, torch.from_numpy(new.astype(np.int32)))))
    assert np.array_equal(to_np(jot.clear_access_and_atc(jw)),
                          to_np(tot.clear_access_and_atc(tw)))
    assert int(to_np(jot.free_word())) == tot.FREE_WORD


@pytest.mark.parametrize("armed", [False, True])
def test_record_access_matches_incl_padding_and_object_zero(armed):
    """Padding (-1) never redirects onto object 0; duplicates bump the ATC
    once; the ATC saturates."""
    rng = np.random.default_rng(1)
    f = _fields(rng, 64)
    f[3] = rng.integers(13, 16, 64)                  # near ATC saturation
    jw = jot.pack(*[jnp.asarray(a, jnp.uint32) for a in f])
    tw = tot.pack(*[torch.from_numpy(a.astype(np.int32)) for a in f])
    for ids in ([-1, 0, 5, 5, -1], [-1, -1], [0], [63, 63, 62, -1, 0]):
        ids = np.asarray(ids, np.int32)
        jw = jot.record_access(jw, jnp.asarray(ids), armed=armed)
        tw = tot.record_access(tw, torch.from_numpy(ids),
                               armed=torch.tensor(armed))
        assert np.array_equal(to_np(jw), to_np(tw))


# ---------------------------------------------------------------------------
# pool traces
# ---------------------------------------------------------------------------
def test_make_config_matches():
    for args in [(64, 8, 4), (7168, 8192, 16), (100, 3, 8)]:
        cfg_t = tpl.make_config(args[0], args[1], sb_slots=args[2],
                                dtype="bfloat16")
        cfg_j = jpl.make_config(args[0], args[1], sb_slots=args[2],
                                dtype="bfloat16")
        assert jax_pool_config(cfg_t) == cfg_j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_traces_bit_identical(seed):
    rng = np.random.default_rng(seed)
    cfg_t = tpl.make_config(48, 8, sb_slots=4, page_slots=2)
    trace = random_trace(rng, 40, cfg_t.max_objects, 8, cfg_t.slot_words)
    jstate, tstate, reads = run_both(cfg_t, trace)
    for jv, tv in reads:
        assert np.array_equal(jv, tv)
    assert_state_equal(jstate, tstate)
    cfg_j = jax_pool_config(cfg_t)
    assert float(jpl.rss_bytes(cfg_j, jstate)) == \
        float(tpl.rss_bytes(cfg_t, tstate))
    assert float(jpl.host_bytes(cfg_j, jstate)) == \
        float(tpl.host_bytes(cfg_t, tstate))
    js, ts = jpl.superblock_stats(cfg_j, jstate), \
        tpl.superblock_stats(cfg_t, tstate)
    for k in js:
        assert np.array_equal(to_np(js[k]), to_np(ts[k])), k


def test_spill_and_exhaustion_match():
    """Allocations past the NEW region spill to COLD then HOT, and a full
    pool refuses the rest — identically."""
    cfg_t = tpl.make_config(40, 4, sb_slots=4, slack=1.0)
    ids = np.arange(cfg_t.max_objects, dtype=np.int32)
    trace = [(tpl.OP_ALLOC, ids, np.ones((len(ids), 4), np.float32))]
    jstate, tstate, _ = run_both(cfg_t, trace)
    assert_state_equal(jstate, tstate)
    assert int(tstate["free_count"].sum()) == cfg_t.n_slots - cfg_t.max_objects


def test_faults_on_host_superblocks_match():
    """Reads of HOST-tier superblocks fault them back to HBM."""
    rng = np.random.default_rng(5)
    cfg_t = tpl.make_config(32, 4, sb_slots=4)
    alloc = [(tpl.OP_ALLOC, np.arange(16, dtype=np.int32),
              rng.normal(size=(16, 4)).astype(np.float32))]
    jstate, tstate, _ = run_both(cfg_t, alloc)
    tier = np.zeros(cfg_t.n_sbs, np.int8)
    tier[::2] = tpl.HOST
    jstate = dict(jstate, sb_tier=jnp.asarray(tier))
    tstate = dict(tstate, sb_tier=torch.from_numpy(tier))
    reads = [(tpl.OP_READ, np.asarray([0, 5, 9, -1, 14], np.int32),
              np.zeros((5, 4), np.float32))]
    jstate, tstate, _ = run_both(cfg_t, reads, jstate, tstate)
    assert_state_equal(jstate, tstate)
    assert int(tstate["total_faults"]) > 0
