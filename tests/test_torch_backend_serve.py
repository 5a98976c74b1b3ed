"""`Server.serve` under each of the six tiering backends against the JAX
`Server.serve`, chatglm3-6b reduced in float32, 7 requests on 2 lanes,
under full pressure (a target of 0 superblocks, which their byte targets
round to; `mglru` protects no generation): identical
Completions, collect reports (the backend's telemetry included) and
per-window gauges, and every leaf of the final state, the backend's
carried `bstate` included (pool data within 1e-5). Every backend but
`null` and `proactive` demotes on the way."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch.core import backend as tbe
from repro_torch.runtime.server import Request as TRequest
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from test_torch_pool import assert_state_equal
from test_torch_server import KW, _models, _requests

ALL = ("null", "proactive", "reactive", "cap", "mglru", "promote")


def _params(name):
    params = tbe.pressure_params(name, 1)
    return dict(params, min_evict_gen=0) if name == "mglru" else params


@pytest.mark.parametrize("name", ALL)
def test_serve_under_backend_matches_jax(name):
    jm, jp, tm, tp = _models("float32")
    kw = dict(**KW, backend=name, backend_params=_params(name))
    js, ts = JServer(jm, JServerConfig(**kw)), TServer(tm, TServerConfig(**kw))
    jres = js.serve(jp, _requests(JRequest))
    tres = ts.serve(tp, _requests(TRequest))
    assert [dataclasses.asdict(r) for r in jres] == \
        [dataclasses.asdict(r) for r in tres]
    assert js.reports == ts.reports and js.serve_log == ts.serve_log
    assert_state_equal(js.state, ts.state, data_tol=1e-5)
    assert ts.kv_rss_bytes() == 0.0
    demoted = sum(r["be_demoted"] for r in ts.reports)
    assert (demoted > 0) == (name not in ("null", "proactive")), demoted
