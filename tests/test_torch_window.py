"""The serve window as one program: the port's window programs
(`Server._window_body` over the window body `Server._run`, what the server
captures as one CUDA graph per window on the card), on the CPU, at
chatglm3-6b reduced in float32.

1. The static-carry "serve" program run eagerly (each window: bind the
   carry to the static buffers, run the body, copy the leaves it replaced
   back: what a graph replay does, op by op) against the serve window
   taken apart (lane events applied eagerly on the live state, then
   `Server.decode_window`), over windows of two collects each
   with lane churn, through a `reset`, with overlap_collect off and on:
   tokens, gauges, reports and every leaf of the state exactly, and the
   pool's `data` never leaves its storage.
2. `Server.serve` against the JAX `Server.serve`, two calls on one server
   (the `reset` path), W = 2 * collect_every, lane churn, overlap_collect
   off and on: Completions, reports, per-window gauges and every leaf of
   the final state (table, slot owners, free rings, block tables, tiers,
   evict states, `bstate`; pool data within 1e-5); and `generate` over
   two whole windows against the JAX `generate`, the same way.
3. Capture safety: one aligned serve window with lane events and
   migrations (greedy and sampled), and the "window" program, under a
   TorchDispatchMode that raises on any op that reads a device value on
   the host or has a data-dependent output shape. On the card such an op
   would fail the graph capture, which nothing catches."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from torch.utils._python_dispatch import TorchDispatchMode

from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.core import engine as teng
from repro_torch.core import pool as tpl
from repro_torch.models import kvcache as tkvc
from repro_torch.runtime.server import Request as TRequest
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from test_torch_pool import assert_state_equal
from test_torch_server import B, EVERY, KW, _models, _requests

W = 2 * EVERY


def _promote(tm):
    """The `promote` backend with its watermarks at 2 and 1 of the pool's
    three superblocks: it carries state, demotes and promotes."""
    sb = TServer(tm, TServerConfig(**KW)).kv_cfg.pool_config().sb_bytes
    return dict(backend="promote",
                backend_params=dict(hbm_high_bytes=2 * sb, hbm_low_bytes=sb))


def _upload(rng, active, temp=0.0):
    """One window's int32 upload [free | admit | top-k | tokens | temp]:
    some live lanes finish, empty lanes admit; prompt tokens or -1."""
    free = active & (rng.random(B) < 0.4)
    admit = ~(active & ~free) & (rng.random(B) < 0.8)
    toks = np.where(rng.random((B, W)) < 0.5,
                    rng.integers(0, 256, (B, W)), -1).astype(np.int32)
    temps = np.where(admit, temp, 0.0).astype(np.float32)
    host = np.concatenate([free, admit, np.where(admit, 3, 0), toks.ravel(),
                           temps.view(np.int32)]).astype(np.int32)
    return torch.from_numpy(host), (active & ~free) | admit


def _unpack(packed):
    """(sampled [B, W], KV RSS bytes, live blocks, reports)."""
    host = packed.tolist()
    n = len(teng.REPORT_KEYS)
    vals = host[B * W + 2:]
    return (np.asarray(host[:B * W], np.int64).reshape(B, W),
            host[B * W], host[B * W + 1],
            [dict(zip(teng.REPORT_KEYS, vals[j:j + n]))
             for j in range(0, len(vals), n)])


def _before_programs(srv, params, inp):
    """The serve window taken apart: lane events applied eagerly on the
    live state, then a `decode_window` of W steps."""
    free, admit = inp[:B].bool(), inp[B:2 * B].bool()
    kv = tkvc.free_lanes(srv.kv_cfg, srv.state, free)
    srv.state = tkvc.admit_lanes(kv, admit)
    srv._temp = torch.where(admit, inp[(3 + W) * B:].view(torch.float32),
                            srv._temp)
    srv._topk = torch.where(admit, inp[2 * B:3 * B], srv._topk)
    _, sampled, reports = srv.decode_window(
        params, inp[3 * B:(3 + W) * B].view(B, W))
    kv = srv.state
    return (sampled.numpy(),
            float(tpl.rss_bytes(srv.kv_cfg.pool_config(), kv["pool"])),
            int((kv["block_tables"] >= 0).sum()),
            teng.window_reports(reports))


def _static_program(srv, params, inp):
    """The "serve" program over the static carry, as a replay runs it."""
    srv._to_static()
    data = srv.state["pool"]["data"]
    body = srv._window_body("serve", params, srv._sample_in_scan,
                            srv._steps)
    new, outs = body(srv._carry(), inp)
    srv._write_back(new)
    srv._steps += W
    assert srv.state["pool"]["data"] is data
    return _unpack(outs["packed"])


@pytest.mark.parametrize("overlap", [False, True])
def test_static_program_matches_generic_window(overlap):
    _, _, tm, tp = _models("float32")
    cfg = TServerConfig(**KW, window=W, overlap_collect=overlap,
                        **_promote(tm))
    prog, ref = TServer(tm, cfg), TServer(tm, cfg)
    rng = np.random.default_rng(5)
    storage = None
    moved = skipped = 0
    for call in range(2):
        prog.reset(active=False)
        ref.reset(active=False)
        active = np.zeros(B, bool)
        for window in range(5):
            inp, active = _upload(rng, active)
            got = _static_program(prog, tp, inp)
            want = _before_programs(ref, tp, inp)
            assert np.array_equal(got[0], want[0]), (call, window)
            assert got[1:3] == want[1:3], (call, window)
            assert got[3] == want[3], (call, window)
            assert_state_equal(ref.state, prog.state)
            assert torch.equal(ref._last_tok, prog._last_tok)
            assert torch.equal(ref._temp, prog._temp)
            assert torch.equal(ref._topk, prog._topk)
            moved += sum(r["moved_to_hot"] + r["moved_to_cold"]
                         for r in got[3])
            skipped += sum(r["skipped_atc"] for r in got[3])
            data = prog.state["pool"]["data"]
            if storage is None:
                storage = data.untyped_storage().data_ptr()
            assert data.untyped_storage().data_ptr() == storage
    # with overlap the closing step's accesses are ATC-armed: no mover
    assert (skipped if overlap else moved) > 0
    assert prog.state["pool"]["bstate"]


_PAIRS = {}


def _serve_pair(overlap):
    """A (JAX, port) server pair with W = 2 * collect_every, one per
    overlap setting (a JAX server compiles its programs once)."""
    if overlap not in _PAIRS:
        jm, _, tm, _ = _models("float32")
        kw = dict(**KW, window=W, overlap_collect=overlap)
        _PAIRS[overlap] = (JServer(jm, JServerConfig(**kw)),
                           TServer(tm, TServerConfig(**kw)))
    return _PAIRS[overlap]


@pytest.mark.parametrize("overlap", [False, True])
def test_serve_twice_matches_jax(overlap):
    _, jp, _, tp = _models("float32")
    js, ts = _serve_pair(overlap)
    for call in range(2):
        jreq, treq = _requests(JRequest), _requests(TRequest)
        if call:
            jreq, treq = jreq[::-2], treq[::-2]
        jres, tres = js.serve(jp, jreq), ts.serve(tp, treq)
        assert [dataclasses.asdict(r) for r in jres] == \
            [dataclasses.asdict(r) for r in tres], call
        assert js.reports == ts.reports and js.serve_log == ts.serve_log
        assert ts.dispatches == len(ts.serve_log) == js.dispatches
        assert len(ts.reports) == 2 * len(ts.serve_log)
        assert_state_equal(js.state, ts.state, data_tol=1e-5)
    key = "skipped_atc" if overlap else "moved_to_hot"
    assert sum(r[key] for r in ts.reports) > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_generate_windows_match_jax(overlap):
    """`generate` over two whole windows of W (the "window" program)."""
    _, jp, _, tp = _models("float32")
    js, ts = _serve_pair(overlap)
    js.reset()
    ts.reset()
    prompts = np.random.default_rng(6).integers(0, 256, (B, 5))
    jout = js.generate(jp, jnp.asarray(prompts, jnp.int32), max_new=2 * W - 4)
    tout = ts.generate(tp, prompts, max_new=2 * W - 4)
    assert np.array_equal(np.asarray(jout), tout.numpy())
    assert js.reports == ts.reports and len(ts.reports) == 4
    assert (js._steps, js.dispatches) == (ts._steps, ts.dispatches) \
        == (2 * W, 2)
    assert_state_equal(js.state, ts.state, data_tol=1e-5)


# ---------------------------------------------------------------------------
# capture safety
# ---------------------------------------------------------------------------
# ops that read a device value on the host or size their output by the data
_HOST_READS = {"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
               "aten::equal", "aten::allclose", "aten::nonzero",
               "aten::masked_select", "aten::bincount",
               "aten::repeat_interleave"}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_",
             "aten::_index_put_impl_"}


class _CaptureBlockers(TorchDispatchMode):
    """Raises on an op that a CUDA graph capture cannot hold; counts the
    ops it let through."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in _HOST_READS or "unique" in name:
            raise AssertionError(f"{name} reads the device on the host")
        if name in _INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError(f"{name} with a boolean mask")
        self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,temp,overlap", [
    ("serve", 0.0, False), ("serve", 0.9, True), ("window", 0.0, False)])
def test_window_program_is_capture_safe(name, temp, overlap):
    _, _, tm, tp = _models("float32")
    srv = TServer(tm, TServerConfig(**KW, window=W, overlap_collect=overlap,
                                    **_promote(tm)))
    srv.reset(active=False)
    srv._sample_in_scan = temp > 0
    rng = np.random.default_rng(2)
    active = np.zeros(B, bool)
    for _ in range(2):                  # lanes filled, blocks to migrate
        inp, active = _upload(rng, active, temp)
        _static_program(srv, tp, inp)
    inp, _ = _upload(rng, active, temp)
    inp[:B] = torch.from_numpy(active)          # every live lane finishes
    inp[B:2 * B] = 1                            # and every lane admits
    x = inp if name == "serve" else inp[3 * B:(3 + W) * B].view(B, W)
    body = srv._window_body(name, tp, temp > 0, srv._steps)
    mode = _CaptureBlockers()
    with mode:
        new, outs = body(srv._carry(), x)
    assert mode.seen["aten::index_put_"] > 0 and mode.seen["aten::sort"] > 0
    reports = (_unpack(outs["packed"])[3] if name == "serve"
               else teng.window_reports(outs["reports"]))
    assert len(reports) == 2
    assert active.any()
    if not overlap:
        assert sum(r["moved_to_hot"] + r["moved_to_cold"]
                   for r in reports) > 0
