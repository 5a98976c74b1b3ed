"""The port's serving launcher (`repro_torch.launch.serve.main(argv)`)
against the JAX package's (`repro.launch.serve.main`, run with `sys.argv`
set and its stdout captured), at reduced glm4-9b and granite-20b, in both
modes.

Both launchers draw their own weights; EOS stops depend on them, so the
port's launcher is given JAX's, carried across by `convert.from_jax`.
Both run their config in float32 (greedy tokens in bfloat16 may flip
between two correct implementations, as `test_torch_server.py` notes):
the generated tokens or the completions, the final KV RSS, the serve log
and the collector reports must be identical, and so must the printed
lines, but for a remark the port's KV RSS line leaves out (the collector
lines' dicts equal, their keys in another order). Without
`--device` the launcher asks for CUDA and raises where there is none."""
import ast
import dataclasses
import sys
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

ARGS = {"generate": ["--requests", "3", "--max-new", "12"],
        "serve": ["--requests", "5", "--lanes", "2", "--max-new", "8"]}


def _f32(get_config):
    return lambda name, reduced=False: dataclasses.replace(
        get_config(name, reduced=reduced), dtype="float32")


def _jax_run(argv, capsys):
    """JAX's launcher on argv: (its params, server, generate / serve
    result, stdout)."""
    got = {}
    init, generate, serve = JModel.init, JServer.generate, JServer.serve

    def keep(name, fn):
        def wrapped(self, *a, **kw):
            got[name] = fn(self, *a, **kw)
            got["server"] = self
            return got[name]
        return wrapped
    with mock.patch.object(sys, "argv", ["serve"] + argv), \
            mock.patch.object(jserve, "get_config",
                              _f32(jserve.get_config)), \
            mock.patch.object(JModel, "init", lambda self, key: got.setdefault(
                "params", init(self, key))), \
            mock.patch.object(JServer, "generate", keep("out", generate)), \
            mock.patch.object(JServer, "serve", keep("out", serve)):
        jserve.main()
    return got, capsys.readouterr().out


@pytest.mark.parametrize("mode", ["generate", "serve"])
@pytest.mark.parametrize("arch", ["glm4-9b", "granite-20b"])
def test_serve_launcher_follows_jax(arch, mode, capsys):
    argv = ["--arch", arch, "--reduced", "--mode", mode] + ARGS[mode]
    want, jax_out = _jax_run(argv, capsys)
    params = convert.from_jax(jax.tree.map(np.asarray, want["params"]))
    with mock.patch.object(tserve, "get_config", _f32(tserve.get_config)), \
            mock.patch.object(TModel, "init", lambda self, gen: params):
        run = tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    srv, js = run["server"], want["server"]
    assert run["params"] is params
    if mode == "generate":
        assert run["results"] is None
        assert np.array_equal(run["tokens"].numpy(), np.asarray(want["out"]))
        assert run["tokens"].shape == (3, 12)
    else:
        assert run["tokens"] is None
        assert [(c.rid, c.tokens, c.finish_reason, tuple(c.windows))
                for c in run["results"]] == \
            [(c.rid, list(c.tokens), c.finish_reason, tuple(c.windows))
             for c in want["out"]]
        assert srv.serve_log == js.serve_log
    assert srv.kv_rss_bytes() == float(js.kv_rss_bytes())
    assert srv.reports == js.reports and srv.reports
    # the same lines, but for a remark the port's KV RSS line leaves out;
    # the collector's dicts are equal, not in the same key order
    assert _lines(out) == _lines(jax_out.replace(
        " (reclaimed after finishes)", ""))


def _lines(text):
    prefix = "  collector: "
    return [ast.literal_eval(line[len(prefix):]) if line.startswith(prefix)
            else line for line in text.splitlines()]


class _Stop(Exception):
    pass


def test_serve_launcher_asks_for_cuda():
    """Without --device the launcher builds its model on `cuda`: here,
    with no card, it raises; with one (simulated) the model's device is
    cuda."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "glm4-9b", "--reduced"])
    seen = []

    def model(cfg, device=None):
        seen.append(TModel(cfg, device=device).device)
        raise _Stop
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(tserve, "Model", model), pytest.raises(_Stop):
        tserve.main(["--arch", "glm4-9b", "--reduced"])
    assert seen == [torch.device("cuda")]
