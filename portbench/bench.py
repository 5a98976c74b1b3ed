"""The harness: finds a cell's configuration, traffic mix and metrics by
the names in `BENCHMARK.json`, runs it (set-up, the measured window, the
check), and prints the result line.

  configs/<config>.py      `make(spec, mix, seed, device, small=None)`:
                           the cell object (`serve_cell`, `engine_cell`)
  configs/<config>.json    the configuration as run (`file` in the JSON)
  traffic/<traffic>.json   the mix, read by `gen`
  metrics/<metric>.py      `read(record) -> float or None` per per-layer
                           metric; None leaves the metric out of the line.
                           A metric split by cell (`<reader>.serve`,
                           `<reader>.engine`) without a file of its own
                           is read by `metrics/<reader>.py`

A cell object has `setup(seconds)`, `run(seconds, trace)`,
`end_to_end()`, `attempted()`, `record()`, `release()` and `check()`.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench import gen

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold '-' and '.')."""
    name = "portbench._by_name." + path.stem.replace("-", "_").replace(
        ".", "_") + "_" + path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among `names` (by default the loaded modules) that
    are, whole, JAX's or the JAX package's: `repro_torch` is not
    `repro`."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules if names is None
                                            else names)}
    return sorted(tops.intersection(FORBIDDEN))


def reader_path(name: str, root: Path = HERE) -> Path:
    """The reader of per-layer metric `name`: metrics/<name>.py, else the
    file named without its last dotted part."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = root / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_cell(bm: Dict, name: str, seed: int, device, small: bool = False):
    """(the cell's entry, its cell object). `small` takes the configuration
    module's CPU-test sizes (`SMALL`) and its shorter mixes
    (`SMALL_MIX[traffic]`), for the tests and rehearsals."""
    cell = next(w for w in bm["workloads"] if w["name"] == name)
    conf = next(c for c in bm["configs"] if c["name"] == cell["config"])
    spec = json.loads((ROOT / conf["file"]).read_text())
    mix = gen.load_mix(cell["traffic"])
    mod = load_module(HERE / "configs" / f"{cell['config']}.py")
    if small:
        mix = dict(mix, **mod.SMALL_MIX[cell["traffic"]])
    return cell, mod.make(spec, mix, seed, device,
                          small=mod.SMALL if small else None)


def run_cell(bm: Dict, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, small: bool = False) -> Dict:
    """One run of cell `name`; returns the result line as a dict (its
    "checks" key last)."""
    import torch
    cell, c = make_cell(bm, name, seed, device, small)
    c.setup(seconds)
    setup_s = time.perf_counter() - t0
    c.run(seconds, trace)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    attempted, failed = c.attempted()
    rec = c.record()
    metrics = {}
    if trace:
        for m in bm["per_layer"]:
            if applies(m, name):
                v = load_module(reader_path(m["name"])).read(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(c.end_to_end(), setup_s=setup_s)
        for m in bm["end_to_end"]:
            if applies(m, name) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else str(device),
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    prof = rec.get("profile")
    if trace and prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {k: [list(x) for x in prof[k]]
                            for k in ("device_ops", "idle_gaps")}
    c.release()
    checks = c.check()
    out["correct"] = failed == 0 and all(
        ch["limit"] is not None and ch["value"] <= ch["limit"]
        for ch in checks)
    out["checks"] = {ch["name"]: {"value": ch["value"], "limit": ch["limit"]}
                     for ch in checks}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bm = load_benchmark()
    cell = next((w for w in bm["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    out = run_cell(bm, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, ch in out["checks"].items():
        print(f"check {name}: {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
