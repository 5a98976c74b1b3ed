#!/usr/bin/env python3
"""Where CrestKV's host time goes: a cProfile of hash-pugh under YCSB-C
with `proactive` at `--keys` keys (the paper's 10 M by default), one window
of 10 M ops, the SimHeap's backend step on `--device` (the card unless
"cpu" is given). Prints the load and run seconds and the functions with
the most time of their own. At 10 M keys it holds ~7 GB of host memory.

    python3 tools/crest_profile.py [--keys N] [--device cpu] [--top 25]
"""
import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    from repro_torch.data.crestkv import CrestKV, default_sim_config
    t0 = time.perf_counter()
    kv = CrestKV("hash-pugh", args.keys, default_sim_config(
        args.keys, backend="proactive"), seed=0, device=args.device)
    print(f"load {time.perf_counter() - t0:.3f} s", flush=True)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    kv.run("C", 10_100_000, window_ops=10_000_000, seed=1)
    prof.disable()
    print(f"one window of 10 M ops {time.perf_counter() - t0:.3f} s",
          flush=True)
    pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
