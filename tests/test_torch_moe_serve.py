"""`Server.serve` on the MoE family (olmoe-1b-7b and mixtral-8x7b,
reduced, float32) against the JAX `Server.serve` on weights converted from
the JAX init: greedy Completions, collect reports, per-window gauges and
every leaf of the final pool state bit for bit (data within 1e-5) under
the `proactive` and `mglru` backends; a bfloat16 window's logits within
3e-2 with the metadata exact; an MoE serve window passes the
capture-safety check of tests/test_torch_window.py; the launcher serves
olmoe on the CPU."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.core import backend as tbe
from repro_torch.runtime.server import Request as TRequest
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from test_torch_moe_model import ARCHS, _err, _models, _toks
from test_torch_pool import assert_state_equal
from test_torch_server import KW, _requests
from test_torch_window import W, _CaptureBlockers, _static_program, _upload

ROOT = Path(__file__).resolve().parents[1]


def _backend_kw(name):
    params = tbe.pressure_params(name, 1)
    return dict(backend=name, backend_params=dict(params, min_evict_gen=0)
                if name == "mglru" else params)


@pytest.mark.parametrize("backend", ["proactive", "mglru"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch, backend):
    """7 greedy requests on 2 lanes: identical Completions, reports,
    per-window gauges and final state; the pool drains to RSS 0."""
    jm, jp, tm, tp = _models(arch)
    kw = dict(**KW, overlap_collect=True, **_backend_kw(backend))
    js, ts = JServer(jm, JServerConfig(**kw)), TServer(tm, TServerConfig(**kw))
    jres = js.serve(jp, _requests(JRequest))
    tres = ts.serve(tp, _requests(TRequest))
    assert [dataclasses.asdict(r) for r in jres] == \
        [dataclasses.asdict(r) for r in tres]
    assert js.reports == ts.reports and js.serve_log == ts.serve_log
    assert_state_equal(js.state, ts.state, data_tol=1e-5)
    assert ts.kv_rss_bytes() == 0.0
    assert ts.dispatches == len(ts.serve_log) == js.dispatches
    assert sum(r["moved_to_hot"] + r["moved_to_cold"] + r["skipped_atc"]
               for r in ts.reports) > 0


def test_bf16_serve_window_logits_and_metadata_match_jax():
    """bfloat16 olmoe, a teacher-forced window: logits within 3e-2, the
    pool metadata exactly (it does not depend on the values)."""
    jm, jp, tm, tp = _models("olmoe-1b-7b", "bfloat16")
    js, ts = JServer(jm, JServerConfig(**KW)), TServer(tm, TServerConfig(**KW))
    toks = _toks(4, s=3 * KW["collect_every"])
    jl, _, _ = js.decode_window(jp, jnp.asarray(toks))
    tl, _, _ = ts.decode_window(tp, toks)
    assert _err(tl, jl) < 3e-2
    assert_state_equal(js.state, ts.state, data_tol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_window_is_capture_safe(arch):
    """A "serve" window program of the MoE server (lane events, W steps,
    collects with migrations) under tests/test_torch_window.py's
    TorchDispatchMode: no op reads the device on the host or sizes its
    output by the data, and the MoE dispatch's sort and scatter ran."""
    _, _, tm, tp = _models(arch)
    srv = TServer(tm, TServerConfig(**KW, window=W))
    srv.reset(active=False)
    rng = np.random.default_rng(2)
    active = np.zeros(KW["batch"], bool)
    for _ in range(2):
        inp, active = _upload(rng, active)
        _static_program(srv, tp, inp)
    inp, _ = _upload(rng, active)
    body = srv._window_body("serve", tp, False, srv._steps)
    mode = _CaptureBlockers()
    with mode:
        body(srv._carry(), inp)
    assert mode.seen["aten::scatter_reduce_"] >= tm.cfg.num_layers * W
    assert mode.seen["aten::sort"] > 0


def test_launch_serve_cli_runs_olmoe_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmoe-1b-7b", "--reduced", "--mode", "serve", "--requests", "3",
         "--max-new", "4", "--device", "cpu"],
        check=True, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    ).stdout
    assert "served 3 requests" in out and "-> final 0.00 MiB" in out
