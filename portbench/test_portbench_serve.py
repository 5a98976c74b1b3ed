"""The served cell driven on the CPU at a toy size (`configs/
chatglm3-6b.py` `SMALL`): a sound run comes out correct, and each fault
that the cell can have, planted under the timed path, makes `correct`
false (there is no exchange between chips on one)."""
import time

import pytest
import torch

from portbench import bench
from repro_torch.core import pool
from repro_torch.models import kvcache
from repro_torch.runtime import server

BM = bench.load_benchmark()
CELL = "chatglm3-6b.chat"
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def one_thread():
    """Toy sizes run fastest on one thread, and leave the other workers
    their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run():
    return bench.run_cell(BM, CELL, SEED, 1.0, False, "cpu",
                          time.perf_counter(), small=True)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 8 and out["failed"] == 0
    assert set(out["metrics"]) == {"gen_tok_s", "resident_frac", "setup_s"}
    assert out["metrics"]["resident_frac"]["value"] >= 1.0
    assert list(out)[-1] == "checks"


def _token_altered(monkeypatch):
    step = server.Server._step

    def altered(self, *a, **kw):
        carry, out = step(self, *a, **kw)
        tok = (out["tok"] + 1) % self.model.cfg.vocab_size
        return dict(carry, tok=tok), dict(out, tok=tok)
    monkeypatch.setattr(server.Server, "_step", altered)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(kvcache, "append_layer",
                        lambda cfg, state, layer, k, v: state)


def _half_batch(monkeypatch):
    step = server.Server._model_step

    def half(self, params, state, tok):
        state, logits = step(self, params, state, tok)
        b = logits.shape[0] // 2
        return state, torch.cat([logits[:b], logits[:logits.shape[0] - b]])
    monkeypatch.setattr(server.Server, "_model_step", half)


def _resident_gauge_off(monkeypatch):
    """The server's resident-bytes gauge one superblock high: the
    harness's recount at each window's close disagrees."""
    rss = pool.rss_bytes

    def high(cfg, state):
        return rss(cfg, state) + float(cfg.sb_bytes)
    monkeypatch.setattr(pool, "rss_bytes", high)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch, _resident_gauge_off])
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]
