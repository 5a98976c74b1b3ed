"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's numbers (`check`), and for
the control seeds also the control's: for a served model the gap of the
tokens that the fp8 reference puts first (`ServeCell.gaps(fp8=True)`),
for the store the plain store that applies each update a window late
(`EngineCell.check(lag=1)`). The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 20

A served cell sets up once and draws each seed's weights into the same
tensors (the captured graph is kept); a store cell sets up per seed. One
JSON line per seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from portbench import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script at the tests' size")
    args = ap.parse_args(argv)
    import torch
    from torch.utils import _pytree as pytree
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    small = args.device == "cpu"
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    bm = bench.load_benchmark()
    cell = None
    for seed in seeds:
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               "card": torch.cuda.get_device_name(0) if args.device == "cuda"
               else "cpu"}
        if args.workload.startswith("chatglm3-6b"):
            if cell is None:
                _, cell = bench.make_cell(bm, args.workload, seed,
                                          args.device, small)
                cell.setup(args.seconds)
            else:
                from portbench.serve_cell import draw_weights
                fresh = draw_weights(cell.srv.model.param_specs(), seed,
                                     cell.device, cell.spec["weights"])
                for a, b in zip(pytree.tree_leaves(cell.params),
                                pytree.tree_leaves(fresh)):
                    a.copy_(b)
                del fresh
                cell.seed = seed
            cell.run(args.seconds, False)
            row.update(cell.gaps(fp8=seed in control),
                       pool_mismatches=cell.accounting(),
                       gen_tok_s=cell.end_to_end()["gen_tok_s"])
        else:
            _, c = bench.make_cell(bm, args.workload, seed, args.device,
                                   small)
            c.setup(args.seconds)
            c.run(args.seconds, False)
            row.update(c.end_to_end())
            c.release()
            row.update({ch["name"]: ch["value"] for ch in c.check()})
            if seed in control:
                row["control_read_mismatches"] = c.replay(lag=1)
            del c
            if args.device == "cuda":
                torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
