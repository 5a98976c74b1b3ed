#!/usr/bin/env python3
"""Train-step memory a device under a remat policy, the JAX package's dry
run beside the port's, on the CPU (both modelled, neither measured).

For each (arch, policy) cell of train_4k on the 256-rank (16, 16) mesh:
JAX's `memory_analysis()` of the compiled step (`repro.launch.dryrun.
run_cell(..., probe=False)`: `temp_size_in_bytes`, which the JAX dry run
itself calls unreliable on the CPU backend, and `argument_size_in_bytes`)
and the port's `repro_torch.launch.dryrun.run_cell` (`peak_memory_in_bytes`,
`temp_size_in_bytes` and the largest storages held at the peak,
`peak_largest`). Each side runs in a process of its own: the JAX dry run
fakes 512 host devices through XLA_FLAGS before JAX starts.

    python3 tools/remat_peaks.py [--archs a,b] [--remats dots,full]
                                 [--out build/remat_peaks]

Prints one line a cell and writes every record to OUT/peaks.json.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = "train_4k"

JAX_SIDE = """
import json, sys
from repro.launch import dryrun
r = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=False,
                    remat=sys.argv[3], probe=False, out_dir=sys.argv[4])
print("RECORD " + json.dumps(r))
"""

PORT_SIDE = """
import json, sys
from repro_torch.launch import dryrun
r = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=False,
                    remat=sys.argv[3], out_dir=sys.argv[4])
print("RECORD " + json.dumps(r))
"""


def _run(code: str, arch: str, remat: str, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code, arch, SHAPE, remat, str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, check=False)
    for line in proc.stdout.splitlines():
        if line.startswith("RECORD "):
            return json.loads(line[len("RECORD "):])
    raise RuntimeError(f"{arch} {remat}: no record\n{proc.stdout[-2000:]}"
                       f"\n{proc.stderr[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="granite-20b,granite-34b,qwen2-vl-72b")
    ap.add_argument("--remats", default="dots,full")
    ap.add_argument("--out", default=str(ROOT / "build" / "remat_peaks"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    gib = 2 ** 30
    rows = []
    for arch in args.archs.split(","):
        for remat in args.remats.split(","):
            j = _run(JAX_SIDE, arch, remat, out / "jax" / remat)
            p = _run(PORT_SIDE, arch, remat, out / "port" / remat)
            row = dict(arch=arch, shape=SHAPE, remat=remat, chips=p["chips"],
                       jax_temp=j.get("temp_size_in_bytes"),
                       jax_argument=j.get("argument_size_in_bytes"),
                       jax_arg_analytic=j["arg_bytes_per_device_analytic"],
                       port_peak=p["peak_memory_in_bytes"],
                       port_temp=p["temp_size_in_bytes"],
                       port_argument=p["argument_size_in_bytes"],
                       port_peak_largest=p["peak_largest"])
            rows.append(row)
            print(f"{arch} {SHAPE} remat={remat} on {row['chips']} ranks: "
                  f"JAX temp {row['jax_temp'] / gib:.2f} GiB, arguments "
                  f"{row['jax_arg_analytic'] / gib:.2f}; port peak "
                  f"{row['port_peak'] / gib:.2f} GiB (temp "
                  f"{row['port_temp'] / gib:.2f}, arguments "
                  f"{row['port_argument'] / gib:.2f}); held at the port's "
                  "peak: " + ", ".join(
                      f"{t['bytes'] / gib:.2f} GiB {t['dtype']} {t['shape']} "
                      f"from {t['op']}" for t in row["port_peak_largest"]),
                  flush=True)
    (out / "peaks.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
