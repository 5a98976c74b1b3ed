"""The benchmark's definition and the harness's guarantees, on the CPU:
BENCHMARK.json against its contract's shape, every name it gives found
as a file, the reference importing nothing of the port, and no module of
JAX or the JAX package in the harness's module graph."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"]: m for m in BM["end_to_end"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["portbench"]
    assert BM["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BM["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in BM[kind]]
    assert len(names) == len(set(names))
    for e in BM[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_every_name_is_a_file():
    for c in BM["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        assert (HERE / "configs" / f"{c['name']}.py").is_file()
    for w in BM["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
    used = {bench.reader_path(m["name"]) for m in BM["per_layer"]}
    assert all(p.is_file() for p in used)
    assert used == set((HERE / "metrics").glob("*.py"))


def test_a_split_metric_falls_back_to_its_reader():
    metrics = HERE / "metrics"
    assert bench.reader_path("device.idle_frac.serve") == \
        metrics / "device.idle_frac.py"
    assert bench.reader_path("serve.ms_per_step") == \
        metrics / "serve.ms_per_step.py"
    assert bench.reader_path("migrate_roofline.engine") == \
        metrics / "migrate_roofline.py"


def test_every_cell_reports_what_its_metrics_move():
    for w in BM["workloads"]:
        reported = {m["name"] for m in BM["end_to_end"]
                    if bench.applies(m, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in BM["per_layer"] if bench.applies(m, w["name"])]
        assert layers
        for m in layers:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in BM["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"


def test_forbidden_names_are_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "jaxtyping", "portbench"]) == []
    assert bench.forbidden_modules(["repro.core.pool", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("torch", "typing", "__future__",
                                           "numpy"), (path.name, m)


def test_harness_module_graph_loads_no_jax():
    """Every module of the harness, the configurations' modules and the
    metric readers, imported in a fresh process with the port on the path,
    leave no module of JAX or the JAX package loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import bench, control, engine_cell, gen, peaks, "
        "rooflines, serve_cell, tracing, zipf\n"
        "from portbench.reference import glm, kvstore, schedule\n"
        "from pathlib import Path\n"
        "for p in sorted(Path(%r).glob('*/*.py')):\n"
        "    if p.parent.name in ('configs', 'metrics'):\n"
        "        bench.load_module(p)\n"
        "import repro_torch.runtime.server, repro_torch.core.engine\n"
        "print(bench.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"), str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
