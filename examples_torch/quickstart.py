"""Quickstart of the PyTorch port: tidy up an address space in ~40 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Allocates 512 objects, hammers a scattered hot subset, and watches the
HADES frontend reorganize the heap: page utilization climbs, the cold
superblocks leave device memory, and reads still return the right bytes.
Runs on the card (`cuda`, which must exist) unless `--device` names
another device. `main` returns the `Hades` frontend it drove.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Hades, HadesOptions, make_config
from repro_torch.core import backend


def main(argv=None) -> Hades:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    # a pool of 512 objects x 32 floats, superblock = 16 slots; any backend
    # of backend.names() works here
    cfg = make_config(max_objects=512, slot_words=32, sb_slots=16,
                      page_slots=4, slack=2.0)
    h = Hades(cfg, HadesOptions(collect_every=4,
                                backend=backend.make("proactive")),
              device=args.device)

    ids = np.arange(512)
    vals = torch.arange(512 * 32, dtype=torch.float32,
                        device=h.device).reshape(512, 32)
    h.alloc(ids, vals)
    h.end_load_phase()                   # load stores != workload accesses
    print(f"allocated: {h.heap_histogram()}  rss={h.rss_bytes()//1024} KiB")

    rng = np.random.default_rng(0)
    hot = rng.permutation(512)[:48]      # scattered hot set
    for _ in range(96):
        h.read(hot[rng.integers(0, 48, size=16)])

    print(f"after tidying: {h.heap_histogram()}")
    print(f"rss={h.rss_bytes()//1024} KiB  host={h.host_bytes()//1024} KiB  "
          f"page_util={h.page_utilization():.2f}")
    print(f"counters: {h.counters()}")

    # correctness: every object still reads back its exact bytes
    assert torch.equal(h.read(ids), vals)
    print("content preserved after", h.counters()["moves"], "migrations ✓")
    return h


if __name__ == "__main__":
    main()
