"""The port's `Hades` frontend, pool ops, KV-cache pieces and
`pool_from_jax` against the JAX package, bit for bit: a quickstart-sized
`Hades` run (`examples/quickstart.py`'s pool and trace) with its outputs,
state, last report and metrics; a JAX state carried across mid-run into
the port; `pool.read` / `write` / `heap_of_slot`; `kvcache.append` /
`collect` / `kv_bytes` / `obj_id` with "migration transparent to
serving"; the 2^20-slot limit of the port's `make_config`; and the device
rule of `Engine`, `Hades` and `SimHeap`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.core import Hades as JHades
from repro.core import HadesOptions as JOptions
from repro.core import backend as jbe
from repro.core import engine as jeng
from repro.core import make_config as jmake_config
from repro.core import object_table as jot
from repro.core import pool as jpl
from repro.models import kvcache as jkvc
from repro_torch.convert import pool_from_jax
from repro_torch.core import Hades as THades
from repro_torch.core import HadesOptions as TOptions
from repro_torch.core import backend as tbe
from repro_torch.core import engine as teng
from repro_torch.core import object_table as tot
from repro_torch.core import pool as tpl
from repro_torch.core.simheap import SimConfig, SimHeap
from repro_torch.models import kvcache as tkvc
from test_engine import _mixed_steps
from test_torch_engine import (JCFG, TCFG, assert_reports_equal, options,
                               run_both)
from test_torch_pool import assert_state_equal, jax_pool_config, to_np

QS_T = tpl.make_config(max_objects=512, slot_words=32, sb_slots=16,
                       page_slots=4, slack=2.0)
QS_J = jax_pool_config(QS_T)


def _quickstart(h, rng, np_vals):
    """examples/quickstart.py's run: alloc 512, end the load phase, 96
    reads of a scattered hot set of 48. Returns the read outputs and the
    metrics after the load phase."""
    ids = np.arange(512)
    h.alloc(ids, np_vals)
    h.end_load_phase()
    loaded = (h.heap_histogram(), h.rss_bytes(), h.host_bytes(),
              h.counters())
    hot = rng.permutation(512)[:48]
    outs = [to_np(h.read(hot[rng.integers(0, 48, size=16)]))
            for _ in range(96)]
    return outs, loaded


def _metrics(h):
    return (h.rss_bytes(), h.host_bytes(), h.heap_histogram(), h.counters())


def test_hades_quickstart_matches_jax():
    vals = np.arange(512 * 32, dtype=np.float32).reshape(512, 32)
    jh = JHades(QS_J, JOptions(collect_every=4,
                               backend=jbe.make("proactive")))
    th = THades(QS_T, TOptions(collect_every=4,
                               backend=tbe.make("proactive")), device="cpu")
    j_outs, j_loaded = _quickstart(jh, np.random.default_rng(0), vals)
    t_outs, t_loaded = _quickstart(th, np.random.default_rng(0), vals)
    assert j_loaded == t_loaded
    assert all(np.array_equal(a, b) for a, b in zip(j_outs, t_outs))
    assert_state_equal(jh.state, th.state)
    assert_reports_equal({k: np.asarray(v) for k, v in jh.last_report.items()},
                         th.last_report)
    assert _metrics(jh) == _metrics(th)
    assert th.counters()["moves"] > 0
    pj, pt = jh.page_utilization(), th.page_utilization()
    assert abs(pj - pt) <= 1e-7 * max(abs(pj), 1e-30)
    # a window with its access bits set (they clear at every collect)
    for h in (jh, th):
        h.read(np.arange(0, 512, 7))
    pj, pt = jh.page_utilization(), th.page_utilization()
    assert 0 < pt <= 1 and abs(pj - pt) <= 1e-7 * pj
    # a forced collect, then every object still reads back its bytes
    jh.collect()
    th.collect()
    assert_state_equal(jh.state, th.state)
    assert_reports_equal({k: np.asarray(v) for k, v in jh.last_report.items()},
                         th.last_report)
    assert np.array_equal(to_np(th.read(np.arange(512))), vals)


@pytest.mark.parametrize("backend", ["mglru", "promote"])
def test_pool_from_jax_continues_bit_for_bit(backend):
    """A JAX state taken after the first window, carried into the port:
    both engines then run the rest of the trace to the same state."""
    steps = _mixed_steps(np.random.default_rng(10))
    jo, to = options(backend, 4, True)
    je = jeng.Engine(JCFG, jo)
    jstate, _, _ = je.run_window(je.init(), jeng.make_trace(JCFG, steps[:8]),
                                 0)
    host = jax.tree.map(np.asarray, jstate)
    tstate = pool_from_jax(host, "cpu")
    assert_state_equal(jstate, tstate)
    assert tstate["table"].dtype == torch.int32 and tstate["bstate"]
    j, t = run_both(jo, to, steps[8:], step0=8, jstate=jstate,
                    tstate=tstate)
    assert_state_equal(j[0], t[0])
    assert np.array_equal(np.asarray(j[1]), t[1].numpy())
    assert_reports_equal(j[2], t[2])


def test_pool_read_write_heap_of_slot_match_jax():
    rng = np.random.default_rng(11)
    n = JCFG.max_objects
    vals = rng.normal(size=(n, JCFG.slot_words)).astype(np.float32)
    js = jpl.alloc(JCFG, jpl.init(JCFG), jnp.arange(n, dtype=jnp.int32),
                   jnp.asarray(vals))
    ts = tpl.alloc(TCFG, tpl.init(TCFG), torch.arange(n, dtype=torch.int32),
                   torch.from_numpy(vals))
    ids = rng.integers(-1, n + 3, 20).astype(np.int32)
    w = rng.normal(size=(20, JCFG.slot_words)).astype(np.float32)
    js = _jwrite(JCFG, js, jnp.asarray(ids), jnp.asarray(w))
    ts = tpl.write(TCFG, ts, torch.from_numpy(ids), torch.from_numpy(w))
    jv, js = _jread(JCFG, js, jnp.asarray(ids))
    tv, ts = tpl.read(TCFG, ts, torch.from_numpy(ids))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert_state_equal(js, ts)
    slots = np.arange(TCFG.n_slots, dtype=np.int32)
    assert np.array_equal(
        np.asarray(jpl.heap_of_slot(JCFG, jnp.asarray(slots))),
        tpl.heap_of_slot(TCFG, torch.from_numpy(slots)).numpy())
    assert to_np(jot.free_word()) == tot.free_word().item()
    assert jot.MAX_SLOTS == tot.MAX_SLOTS == 1 << 20


# the JAX calls jitted (eager jnp takes tens of seconds here)
_jread = jax.jit(jpl.read, static_argnums=0)
_jwrite = jax.jit(jpl.write, static_argnums=0)
_jappend = jax.jit(jkvc.append, static_argnums=0)
_jattend = jax.jit(jkvc.attend, static_argnums=(0, 2))
_jcollect = jax.jit(jkvc.collect, static_argnums=0)

KV = dict(num_layers=2, batch=3, max_blocks=8, block_tokens=4,
          num_kv_heads=2, head_dim=16, dtype="float32")
JKV, TKV = jkvc.KVCacheConfig(**KV), tkvc.KVCacheConfig(**KV)


def _fill_both(steps, rng):
    js, ts = jkvc.init(JKV), tkvc.init(TKV, device="cpu")
    for _ in range(steps):
        k = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
        js = _jappend(JKV, js, jnp.asarray(k), jnp.asarray(v))
        ts = tkvc.append(TKV, ts, torch.from_numpy(k), torch.from_numpy(v))
    return js, ts


def test_kvcache_append_collect_match_jax():
    """test_tiering_integrations.py's "migration transparent to serving"
    on both packages: append 9 tokens, attend, five collects (some armed),
    attend again; metadata and KV bit for bit, attention within 1e-5."""
    rng = np.random.default_rng(0)
    js, ts = _fill_both(9, rng)
    assert_state_equal(js, ts)
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    jo0, js = _jattend(JKV, js, 1, jnp.asarray(q))
    to0, ts = tkvc.attend(TKV, ts, 1, torch.from_numpy(q))
    for i in range(5):
        if i % 2:
            js, ts = jkvc.arm(js), tkvc.arm(ts)
        js, jrep = _jcollect(JKV, js)
        ts, trep = tkvc.collect(TKV, ts)
        jrep.pop("sb_stats")
        trep.pop("sb_stats")
        assert_reports_equal({k: np.asarray(v) for k, v in jrep.items()},
                             trep)
    assert_state_equal(js, ts)
    jo1, js = _jattend(JKV, js, 1, jnp.asarray(q))
    to1, ts = tkvc.attend(TKV, ts, 1, torch.from_numpy(q))
    assert (to0 - to1).abs().max().item() < 1e-5
    assert np.abs(np.asarray(jo1) - to1.numpy()).max() < 1e-5
    assert int(ts["pool"]["total_moves"]) > 0
    assert_state_equal(js, ts)
    assert jkvc.kv_bytes(JKV) == tkvc.kv_bytes(TKV)
    for ijk in ((0, 0, 0), (1, 2, 7), (1, 1, 3)):
        assert JKV.obj_id(*ijk) == TKV.obj_id(*ijk)


def test_kvcache_append_drops_past_capacity_like_jax():
    """33 tokens into 8 blocks of 4: the last is dropped by both."""
    js, ts = _fill_both(33, np.random.default_rng(1))
    assert_state_equal(js, ts)


def test_make_config_refuses_slots_past_the_word():
    """The table word keeps a slot in 20 bits. The port refuses a pool of
    2^20 + 1 slots (the JAX package builds it and would wrap slot 2^20 to
    0), and takes the 2^20-slot YCSB pool (699,050 objects x 1.5)."""
    kw = dict(sb_slots=1, page_slots=1, slack=1.0)
    with pytest.raises(ValueError):
        tpl.make_config((1 << 20) + 1, 4, **kw)
    assert jmake_config((1 << 20) + 1, 4, **kw).n_slots == (1 << 20) + 1
    assert tpl.make_config(1 << 20, 4, **kw).n_slots == tot.MAX_SLOTS
    cfg = tpl.make_config(699050, 256, sb_slots=64, page_slots=4, slack=1.5)
    assert int(699050 * 1.5) == 1048575
    assert (cfg.n_slots, cfg.n_sbs, cfg.slot_bytes) == (1 << 20, 16384, 1024)
    assert cfg == tpl.PoolConfig(**{
        f: getattr(jmake_config(699050, 256, sb_slots=64, page_slots=4,
                                slack=1.5), f)
        for f in ("max_objects", "slot_words", "sb_slots", "page_slots",
                  "new_sbs", "hot_sbs", "cold_sbs", "dtype", "word_bytes")})


def test_entry_points_take_the_card_or_raise(monkeypatch):
    """Without CUDA and without device="cpu", `Engine`, `Hades`,
    `SimHeap` and `make_trace` raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = SimConfig(max_objects=16, heap_bytes=1 << 16)
    for make in (lambda: teng.Engine(TCFG), lambda: THades(TCFG),
                 lambda: SimHeap(sim), lambda: teng.make_trace(TCFG, [])):
        with pytest.raises(RuntimeError):
            make()
    assert teng.Engine(TCFG, device="cpu").device.type == "cpu"
    assert SimHeap(sim, device="cpu").device.type == "cpu"
