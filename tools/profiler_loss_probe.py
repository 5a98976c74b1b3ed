"""Measures torch.profiler's loss of device records on a CUDA card, and
whether chip_smoke's sentinel check (`chip_smoke.trace_events`) sees it.

Each of many short traces profiles a known chain of elementwise kernels
(65 or 3000 calls, kernels named by their functor), opened by
`chip_smoke.open_trace` and closed by `chip_smoke.close_trace`. A trace's
work is whole when the kernels it recorded are exactly the chain; the
sentinel check calls it whole when both of its marks are recorded. The
probe counts traces that lost work records (and how many each lost),
traces the check refuses, traces that lost work records although the
check passed them (the check's misses), and the opening pad kernels each
trace lost, and prints them as one JSON object on its last line.

    python3 tools/profiler_loss_probe.py [--seconds 300]

Needs a CUDA card; exits 2 without one.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KINDS = ("abs", "neg", "exp", "sin", "cos", "sqrt", "tanh", "sigmoid",
         "reciprocal", "ceil", "floor", "trunc")


def chain(n):
    """The kernel kinds n calls launch, in order (exp is clamped back)."""
    out = []
    for i in range(n):
        out.append(KINDS[i % len(KINDS)])
        if out[-1] == "exp":
            out.append("clamp")
    return out


def kind(name):
    low = name.lower()
    return next((k for k in ("clamp",) + KINDS if k in low), name[:40])


def one(x, n):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.open_trace()
        for i in range(n):
            k = KINDS[i % len(KINDS)]
            getattr(x, k + "_")()
            if k == "exp":
                x.clamp_(0.5, 2.0)
        cs.close_trace()
    events, ok = cs.trace_events(prof)
    pads = sum(cs.SENTINEL in e.name and e.time_range.elapsed_us()
               <= cs.MARK_US for e in prof.events())
    cuda_t = torch.autograd.DeviceType.CUDA
    got = [kind(e.name) for e in sorted(
        (e for e in events if e.device_type == cuda_t),
        key=lambda e: e.time_range.start)]
    return got == chain(n), ok, len(chain(n)) - len(got), cs.OPEN_PAD - pads


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    x = torch.rand(1 << 16, device="cuda") + 1.0
    res = dict(card=card, traces=0, work_lost=0, refused=0, missed=0,
               records_lost=[], pads_lost=[])
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        n = 3000 if res["traces"] % 3 == 0 else 65
        whole, ok, lost, pads_lost = one(x, n)
        res["traces"] += 1
        res["refused"] += not ok
        if pads_lost:
            res["pads_lost"].append(pads_lost)
        if not whole:
            res["work_lost"] += 1
            res["missed"] += ok
            res["records_lost"].append(lost)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
