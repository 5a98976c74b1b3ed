"""The port's examples (`examples_torch/*.py`) against their JAX twins
(`examples/*.py`, run through `runpy.run_path`: their globals, or their
`run` / `main` functions), on the CPU:

  * quickstart: the heap histograms, RSS, host bytes, Page Utilization and
    counters exactly equal (the port's script prints the same lines);
  * serve_kv: JAX's weights carried across (`convert.from_jax`), greedy
    tokens identical and the collector reports within 1e-6;
  * ycsb_crestkv: `run` at 2,000 keys for hash-pugh, baseline and HADES:
    Page Utilization, RSS, overhead and faults exactly equal;
  * train_lm: `--tiny` (2 layers at width 64, vocab 512; JAX's example
    cut to the same sizes through its `dataclasses.replace`) with JAX's
    weights carried across, 3 steps, every step logged: losses within
    1e-4 and learning rates within 1e-10, as `test_torch_train.py` holds
    the trainer.

serve_kv and train_lm run their configs in float32 on both sides, as the
port's other JAX-parity tests of greedy tokens and of training do
(`test_torch_server.py`, `test_torch_train.py`). Without `--device` every
example asks for CUDA and raises where there is none."""
import dataclasses
import runpy
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import repro.models.model as jmodel  # noqa: E402
import repro_torch.models.model as tmodel  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_kv", "train_lm", "ycsb_crestkv")


def _jax(name, **kw):
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"), **kw)


def _port(name):
    """The port's example as a module namespace (not run as __main__)."""
    return runpy.run_path(str(ROOT / "examples_torch" / f"{name}.py"))


def test_quickstart_equals_jax(capsys):
    want = _jax("quickstart")["h"]
    jax_out = capsys.readouterr().out
    h = _port("quickstart")["main"](["--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    assert h.heap_histogram() == want.heap_histogram()
    assert h.rss_bytes() == want.rss_bytes()
    assert h.host_bytes() == want.host_bytes()
    assert h.page_utilization() == want.page_utilization()
    assert h.counters() == want.counters()
    assert h.counters()["moves"] > 0


def _f32_build(module, get_config):
    """`module.build` giving the reduced config in float32."""
    return mock.patch.object(
        module, "build", lambda arch, reduced=False, **kw: module.Model(
            dataclasses.replace(get_config(arch, reduced=reduced),
                                dtype="float32"), **kw))


def test_serve_kv_equals_jax():
    with _f32_build(jmodel, jget_config):
        want = _jax("serve_kv")
    params = convert.from_jax(jax.tree.map(np.asarray, want["params"]))
    with _f32_build(tmodel, tget_config), \
            mock.patch.object(tmodel.Model, "init", lambda self, gen: params):
        srv, out = _port("serve_kv")["main"](["--device", "cpu"])
    assert out.shape == (4, 48)
    assert np.array_equal(out.numpy(), np.asarray(want["out"]))
    js = want["srv"]
    assert len(srv.reports) == len(js.reports) > 0
    for got, ref in zip(srv.reports, js.reports):
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, k
    assert srv.kv_rss_bytes() == float(js.kv_rss_bytes())


@pytest.mark.parametrize("enabled,backend", [(False, "null"),
                                             (True, "proactive")])
def test_ycsb_crestkv_equals_jax(enabled, backend):
    want = _jax("ycsb_crestkv")["run"]("hash-pugh", enabled, backend, 2000)
    got = _port("ycsb_crestkv")["run"]("hash-pugh", enabled, backend, 2000,
                                       device="cpu")
    assert got == want


def test_train_lm_equals_jax(tmp_path):
    """3 steps of the tiny model, each logged (both examples' TrainerConfig
    given log_every=1: at their log_every of 10 a 3-step run logs its last
    step only, and both scripts assert that the loss fell)."""
    port = _port("train_lm")
    tiny = port["TINY"]
    jax_main = _jax("train_lm")["main"]
    got = {}

    def log_every_step(cls):
        return lambda **kw: cls(**dict(kw, log_every=1))

    class JModel(jmodel.Model):
        def init(self, key):
            got["params"] = jax.tree.map(np.asarray, super().init(key))
            return got["params"]

    class JTrainer(jax_main.__globals__["Trainer"]):
        def run(self, *a, **kw):
            got["out"] = super().run(*a, **kw)
            return got["out"]
    jg = jax_main.__globals__
    shim = type("dataclasses", (), {"replace": staticmethod(
        lambda cfg, **kw: dataclasses.replace(cfg, **tiny,
                                              dtype="float32"))})
    with mock.patch.dict(jg, dataclasses=shim, Model=JModel,
                         Trainer=JTrainer, TrainerConfig=log_every_step(
                             jg["TrainerConfig"])), \
            mock.patch("sys.argv", ["train_lm", "--steps", "3",
                                    "--ckpt-dir", str(tmp_path / "jax")]):
        jax_main()
    want = got["out"]
    params = convert.from_jax(got["params"])
    tg = port["main"].__globals__
    f32 = tg["get_config"]
    with mock.patch.dict(tg, get_config=lambda arch: dataclasses.replace(
            f32(arch), dtype="float32"), TrainerConfig=log_every_step(
            tg["TrainerConfig"])), \
            mock.patch.object(tmodel.Model, "init", lambda self, gen: params):
        out = port["main"](["--steps", "3", "--tiny", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "torch")])
    assert out["step"] == want["step"] == 3
    assert [s for s, _ in out["history"]] == [1, 2, 3]
    for (_, t), (_, j) in zip(out["history"], want["history"]):
        assert abs(t["loss"] - j["loss"]) < 1e-4
        assert abs(t["lr"] - j["lr"]) < 1e-10


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_ask_for_cuda(name):
    """Without --device each example runs on `cuda`, and here, with no
    card, raises before it does any work."""
    argv = {"train_lm": ["--tiny", "--steps", "1"],
            "ycsb_crestkv": ["--keys", "2000"]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port(name)["main"](argv)
