"""The paper's experiment in one script, on the PyTorch port: CrestKV +
YCSB-C, baseline vs HADES, on any of the ten Table-1 structures.

    PYTHONPATH=src python examples_torch/ycsb_crestkv.py
        [--structure masstree] [--keys N] [--device cpu]

Placement runs on the host; each window's backend step runs on the card
(`cuda`, which must exist) unless `--device` names another device.
`main` returns both runs' numbers.
"""
import argparse

from repro_torch.data.crestkv import CrestKV, default_sim_config


def run(structure: str, enabled: bool, backend: str, n_keys: int,
        device=None):
    cfg = default_sim_config(n_keys, backend=backend, enabled=enabled)
    kv = CrestKV(structure, n_keys, cfg, seed=0, device=device)
    stats = kv.run("C", n_ops=n_keys * 40, window_ops=n_keys * 2, seed=1)
    last = stats.windows[-1]
    return {
        "page_util": last["page_utilization"],
        "rss_mib": last["rss_bytes"] / 2 ** 20,
        "overhead_pct": stats.overhead_frac * 100,
        "faults": stats.faults,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--structure", default="hash-pugh")
    ap.add_argument("--keys", type=int, default=100_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    print(f"structure={args.structure}, {args.keys} keys, YCSB-C "
          f"(zipfian, active ~1/3, scattered)\n")
    base = run(args.structure, enabled=False, backend="null",
               n_keys=args.keys, device=args.device)
    hades = run(args.structure, enabled=True, backend="proactive",
                n_keys=args.keys, device=args.device)
    print(f"{'':16s}{'baseline':>12s}{'HADES':>12s}")
    print(f"{'page util':16s}{base['page_util']:>12.2f}"
          f"{hades['page_util']:>12.2f}")
    print(f"{'rss (MiB)':16s}{base['rss_mib']:>12.1f}"
          f"{hades['rss_mib']:>12.1f}")
    print(f"{'overhead (%)':16s}{base['overhead_pct']:>12.2f}"
          f"{hades['overhead_pct']:>12.2f}")
    print(f"{'faults':16s}{base['faults']:>12d}{hades['faults']:>12d}")
    red = 1 - hades["rss_mib"] / base["rss_mib"]
    print(f"\nmemory reduction: {red*100:.0f}%  "
          f"(paper: up to 70%)")
    return {"baseline": base, "hades": hades, "memory_reduction": red}


if __name__ == "__main__":
    main()
