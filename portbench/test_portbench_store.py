"""The store cell driven on the CPU at a toy size (`configs/ycsb-699k.py`
`SMALL`): a sound run comes out correct; the control (the plain store
that applies each update a window late) and each fault that the cell can
have, planted in the pool's op under the timed path, do not."""
import time

import pytest
import torch

from portbench import bench, engine_cell, gen
from repro_torch.core import engine, pool

BM = bench.load_benchmark()
CELL = "ycsb-699k.b-zipf"
SEED = 2 ** 31 + 13


@pytest.fixture(autouse=True)
def one_thread():
    """Toy sizes run fastest on one thread, and leave the other workers
    their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run():
    return bench.run_cell(BM, CELL, SEED, 0.5, False, "cpu",
                          time.perf_counter(), small=True)


def test_sound_run_is_correct_and_the_control_is_not():
    _, c = bench.make_cell(BM, CELL, SEED, "cpu", small=True)
    c.setup(0.5)
    c.run(0.5, False)
    c.release()
    checks = c.check()
    assert all(ch["value"] <= ch["limit"] for ch in checks), checks
    assert c.replay(lag=1) > 0


def test_keys_drawn_in_chunks_are_the_stream_the_check_draws_again():
    _, c = bench.make_cell(BM, CELL, SEED, "cpu", small=True)
    c.setup(0.5)
    n = engine_cell.CHUNK + 3
    run = torch.stack([c._keys(i).clone() for i in range(n)])
    again = gen.YcsbKeys(c.mix, c.pcfg.max_objects, SEED, "cpu")
    assert torch.equal(run, torch.stack([again.window() for _ in range(n)]))


def test_result_line():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"ops_s", "op_p95_ms", "resident_frac",
                                   "setup_s"}
    assert out["metrics"]["resident_frac"]["value"] >= 1.0
    assert out["attempted"] % (20 * 256) == 0


def _wrap(monkeypatch, change):
    apply = pool.apply_op

    def faulty(cfg, state, op, ids, values):
        return change(apply, cfg, state, op, ids, values)
    monkeypatch.setattr(pool, "apply_op", faulty)


def _state_unchanged(apply, cfg, state, op, ids, values):
    if op == pool.OP_WRITE:
        return state, torch.zeros_like(values)
    return apply(cfg, state, op, ids, values)


def _half_batch(apply, cfg, state, op, ids, values):
    if op == pool.OP_WRITE:
        ids = torch.where(torch.arange(ids.numel()) < ids.numel() // 2,
                          ids, -1)
    return apply(cfg, state, op, ids, values)


def _answer_altered(apply, cfg, state, op, ids, values):
    state, vals = apply(cfg, state, op, ids, values)
    if op == pool.OP_READ:
        vals = vals.clone()
        vals[::8] += 1.0
    return state, vals


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    _wrap(monkeypatch, fault)
    out = _run()
    assert not out["correct"], out["checks"]


def test_a_resident_gauge_off_from_the_recount_is_not_correct(monkeypatch):
    """Each window's reported resident bytes one superblock high: the
    harness's recount after each window disagrees."""
    collect = engine.collect_and_backend

    def high(pool_cfg, col_cfg, backend, state):
        state, report = collect(pool_cfg, col_cfg, backend, state)
        return state, dict(report,
                           rss_bytes=report["rss_bytes"] + pool_cfg.sb_bytes)
    monkeypatch.setattr(engine, "collect_and_backend", high)
    out = _run()
    assert not out["correct"], out["checks"]
