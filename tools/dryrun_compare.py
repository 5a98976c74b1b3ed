#!/usr/bin/env python3
"""Two sets of dry-run records side by side (`python -m
repro_torch.launch.dryrun` writes them, one JSON a cell): for each cell in
both, the modelled peak a device (GiB), FLOPs a device, the collective
operand bytes a device by kind and mesh axis (GB), MODEL/HLO
(`roofline.analyse`) and the three largest storages held at the peak
(where the record has them). Every number is modelled, none measured.

    python3 tools/dryrun_compare.py OLD_DIR NEW_DIR [--cells a_b,c_d]
"""
import argparse
import glob
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _load(d: str) -> dict:
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if "flops" in rec:
            out[rec["cell"]] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--cells", default=None,
                    help="comma-separated cell names (default: every cell "
                    "in both)")
    args = ap.parse_args()
    from repro_torch.launch.roofline import analyse
    old, new = _load(args.old), _load(args.new)
    cells = args.cells.split(",") if args.cells else sorted(set(old) &
                                                            set(new))
    for cell in cells:
        a, b = old[cell], new[cell]
        print(f"{cell}:")
        print(f"  peak GiB/dev {a['peak_memory_in_bytes'] / 2 ** 30:.2f} -> "
              f"{b['peak_memory_in_bytes'] / 2 ** 30:.2f}")
        print(f"  flops/dev {a['flops']:.4e} -> {b['flops']:.4e} "
              f"(-{a['flops'] - b['flops']:.4e})")
        print(f"  MODEL/HLO {analyse(a)['useful_ratio']:.3f} -> "
              f"{analyse(b)['useful_ratio']:.3f}")
        for label in sorted(set(a["collective_axes"]) |
                            set(b["collective_axes"])):
            x = a["collective_axes"].get(label, {"bytes": 0})["bytes"]
            y = b["collective_axes"].get(label, {"bytes": 0})["bytes"]
            print(f"  {label}: {x / 1e9:.3f} -> {y / 1e9:.3f} GB")
        for t in b.get("peak_largest", []):
            print(f"  held at the peak: {t['bytes'] / 2 ** 30:.2f} GiB "
                  f"{t['dtype']} {t['shape']} from {t['op']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
