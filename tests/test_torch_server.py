"""The slice as a whole: the port's `Server` (chatglm3-6b reduced, weights
converted from the JAX model by `repro_torch.convert`) against the JAX
`Server` on the same inputs.

In float32 (both sides `dataclasses.replace(cfg, dtype="float32")`):
`decode_window` (aligned and generic lengths, overlap_collect on and off),
`generate` and a greedy `serve()` of 7 requests on 2 lanes give identical
tokens and Completions, logits within 1e-4, pool data within 1e-5, and
pool metadata and reports exactly equal. In bfloat16, teacher-forced
windows give logits within 3e-2 (a bf16 token flip would feed different
tokens back, so tokens are compared in float32 only) and the same pool
metadata, which does not depend on the values. Sampling replays numpy
Gumbel noise into both samplers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.core import engine as jeng
from repro.models.model import Model as JModel
from repro.runtime import sampling as jsampling
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import engine as teng
from repro_torch.models.model import Model as TModel
from repro_torch.runtime import sampling as tsampling
from repro_torch.runtime.server import Request as TRequest
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from test_torch_pool import assert_state_equal

B, EVERY = 2, 4
KW = dict(batch=B, max_len=32, block_tokens=4, collect_every=EVERY)
ARCH = "chatglm3-6b"

_CACHE = {}


def _models(dtype):
    """(jax model, jax params, port model, port params), one per dtype."""
    if dtype not in _CACHE:
        jm = JModel(dataclasses.replace(jget_config(ARCH, reduced=True),
                                        dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TModel(dataclasses.replace(tget_config(ARCH, reduced=True),
                                        dtype=dtype), device="cpu")
        tp = convert.from_jax(jax.tree.map(np.asarray, jp))
        _CACHE[dtype] = (jm, jp, tm, tp)
    return _CACHE[dtype]


def _servers(dtype="float32", **kw):
    """A (jax, port) server pair, shared across the file's tests (a JAX
    server compiles its window programs once per instance) and reset."""
    key = (dtype, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jm, _, tm, _ = _models(dtype)
        _CACHE[key] = (JServer(jm, JServerConfig(**KW, **kw)),
                       TServer(tm, TServerConfig(**KW, **kw)))
    js, ts = _CACHE[key]
    js.reset()
    ts.reset()
    return js, ts


def _toks(t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, t)) \
        .astype(np.int32)


def _assert_kv_equal(js, ts, data_tol=1e-5):
    assert_state_equal(js.state, ts.state, data_tol=data_tol)


def test_converted_params_and_config_match():
    jm, jp, tm, tp = _models("float32")
    for f in dataclasses.fields(jm.cfg):
        if f.name != "hades":
            assert getattr(jm.cfg, f.name) == getattr(tm.cfg, f.name), f.name
    assert dataclasses.asdict(jm.cfg.hades) == dataclasses.asdict(tm.cfg.hades)
    assert len(tp["layers"]) == jm.cfg.num_layers
    assert np.array_equal(np.asarray(jp["layers"]["wq"][1]),
                          tp["layers"][1]["wq"].numpy())
    assert tuple(tp["out"].shape) == (jm.cfg.d_model, jm.cfg.vocab_size)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("t", [EVERY, EVERY + 2])
def test_decode_window_matches_jax(overlap, t):
    """Aligned (one whole window, the shape `generate` reuses) and generic
    (t % every != 0) lengths."""
    _, jp, _, tp = _models("float32")
    js, ts = _servers(overlap_collect=overlap)
    toks = _toks(t)
    jl, jsamp, jrep = js.decode_window(jp, jnp.asarray(toks))
    tl, tsamp, trep = ts.decode_window(tp, toks)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4
    assert np.array_equal(np.asarray(jsamp), tsamp.numpy())
    assert jeng.window_reports(jrep) == teng.window_reports(trep)
    assert len(teng.window_reports(trep)) == t // EVERY
    _assert_kv_equal(js, ts)
    assert (js._steps, js.dispatches) == (ts._steps, ts.dispatches) == (t, 1)


def test_decode_step_matches_decode_window():
    """One window == t per-step calls of the port (the per-step path is
    the reference), including the collect reports."""
    _, _, tm, tp = _models("float32")
    ts_a = TServer(tm, TServerConfig(overlap_collect=True, **KW))
    ts_b = TServer(tm, TServerConfig(overlap_collect=True, **KW))
    toks = _toks(2 * EVERY, seed=4)
    la = torch.stack([ts_a.decode_step(tp, toks[:, i])[0]
                      for i in range(2 * EVERY)], dim=1)
    lb, _, rep = ts_b.decode_window(tp, toks)
    assert torch.equal(la, lb)
    assert ts_a.reports == teng.window_reports(rep)
    assert_state_equal(ts_a.state, ts_b.state)
    assert (ts_a.dispatches, ts_b.dispatches) == (2 * EVERY, 1)


@pytest.mark.parametrize("overlap", [False, True])
def test_generate_matches_jax(overlap):
    _, jp, _, tp = _models("float32")
    js, ts = _servers(overlap_collect=overlap)
    prompts = _toks(3, seed=1)
    jout = js.generate(jp, jnp.asarray(prompts), max_new=10)
    tout = ts.generate(tp, prompts, max_new=10)
    assert np.array_equal(np.asarray(jout), tout.numpy())
    assert js.reports == ts.reports
    assert js.dispatches == ts.dispatches == -(-(3 + 10 - 1) // EVERY)
    _assert_kv_equal(js, ts)


def _requests(cls):
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(6):
        n = int(rng.integers(2, 9))
        reqs.append(cls(prompt=rng.integers(0, 256, n).tolist(),
                        max_new=int(rng.integers(3, 12))))
    reqs.append(cls(prompt=rng.integers(0, 256, 20).tolist(), max_new=30))
    return reqs


def test_serve_matches_jax():
    """7 requests on 2 lanes with overlap_collect: identical Completions
    (tokens, finish reasons, window spans), reports and per-window gauges;
    one dispatch per window; the pool drains to RSS 0. The EOS token is
    taken from the port's own greedy continuation so that one request
    finishes on EOS, and the last request runs into lane capacity."""
    _, jp, tm, tp = _models("float32")
    probe = TServer(tm, TServerConfig(**KW))
    first = _requests(TRequest)[0]
    cont = probe.generate(tp, np.asarray([first.prompt] * B), max_new=3)
    eos = int(cont[0, 1])
    js, ts = _servers(overlap_collect=True)
    js.cfg.eos_token = ts.cfg.eos_token = eos    # read on the host only
    jres = js.serve(jp, _requests(JRequest))
    tres = ts.serve(tp, _requests(TRequest))
    assert [dataclasses.asdict(r) for r in jres] == \
        [dataclasses.asdict(r) for r in tres]
    assert {r.finish_reason for r in tres} == {"eos", "length"}
    assert tres[-1].finish_reason == "length" and len(tres[-1].tokens) < 30
    assert js.reports == ts.reports
    assert js.serve_log == ts.serve_log
    assert ts.dispatches == len(ts.serve_log) == js.dispatches
    assert len(ts.reports) == len(ts.serve_log)          # one collect/window
    assert ts.kv_rss_bytes() == 0.0 and ts.kv_live_bytes() == 0.0
    assert max(e["rss_bytes"] for e in ts.serve_log) > 0
    _assert_kv_equal(js, ts)


def test_bf16_teacher_forced_logits_and_metadata():
    _, jp, _, tp = _models("bfloat16")
    js, ts = _servers("bfloat16")
    toks = _toks(3 * EVERY, seed=5)
    jl, _, jrep = js.decode_window(jp, jnp.asarray(toks))
    tl, _, trep = ts.decode_window(tp, toks)
    assert np.abs(np.asarray(jl) - tl.float().numpy()).max() < 3e-2
    assert jeng.window_reports(jrep) == teng.window_reports(trep)
    # metadata exactly. The bf16 K/V payloads of layer >= 1 carry the
    # earlier layers' bf16 roundings, which the two frameworks place
    # differently: within 5e-2 (values are O(1); logits agree within 3e-2)
    _assert_kv_equal(js, ts, data_tol=5e-2)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_sample_replays_numpy_noise_like_jax(monkeypatch):
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    noise = rng.gumbel(size=(6, 50)).astype(np.float32)
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, -1.0, 2.0], np.float32)
    topk = np.asarray([0, 0, 3, 10, 5, 1], np.int32)
    monkeypatch.setattr(jsampling.jax.random, "gumbel",
                        lambda key, shape, dtype: jnp.asarray(noise))
    want = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                            jnp.asarray(temp), jnp.asarray(topk))
    got = tsampling.sample(torch.from_numpy(logits), torch.from_numpy(temp),
                           torch.from_numpy(topk),
                           noise=torch.from_numpy(noise))
    assert np.array_equal(np.asarray(want), got.numpy())
    # top-k membership with generator noise
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample(torch.from_numpy(logits),
                               torch.ones(6), torch.full((6,), 3,
                                                         dtype=torch.int32),
                               generator=g)
        top3 = np.argsort(-logits, axis=1)[:, :3]
        assert all(int(tok[i]) in top3[i] for i in range(6))


def test_sampled_serve_and_generate_reproducible():
    _, _, tm, tp = _models("float32")
    reqs = [TRequest(prompt=[5, 6, 7], max_new=6, temperature=0.9, top_k=8),
            TRequest(prompt=[1, 2], max_new=5, temperature=0.0),
            TRequest(prompt=[9], max_new=7, temperature=1.5, top_k=0)]
    runs = []
    for seed in (1, 1, 2):
        srv = TServer(tm, TServerConfig(**KW))
        res = srv.serve(tp, reqs, generator=torch.Generator().manual_seed(seed))
        runs.append([r.tokens for r in res])
        assert srv.kv_rss_bytes() == 0.0
    assert runs[0] == runs[1] and runs[0] != runs[2]
    with pytest.raises(ValueError):
        TServer(tm, TServerConfig(**KW)).serve(tp, reqs)
    srv = TServer(tm, TServerConfig(temperature=0.8, top_k=4, **KW))
    a = srv.generate(tp, _toks(3), max_new=6, greedy=False,
                     generator=torch.Generator().manual_seed(3))
    srv.reset()
    b = srv.generate(tp, _toks(3), max_new=6, greedy=False,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        srv.generate(tp, _toks(3), max_new=6, greedy=False)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without CUDA, an entry point that was not asked for the CPU
    raises instead of silently running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TModel(tget_config(ARCH, reduced=True))
