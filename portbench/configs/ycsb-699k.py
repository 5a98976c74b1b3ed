"""ycsb-699k: a YCSB key-value store of 699,050 records of 1 KiB on the
port's object engine, the most records one pool can address (2^20 slots
at slack 1.5); `configs/ycsb-699k.json` has the settings. Its plain
reference is `reference/kvstore.py`."""
from __future__ import annotations

from portbench.engine_cell import EngineCell

# the CPU tests' size: 4,096 records of 32 bytes, 256 keys a step
SMALL = {"recordcount": 4096, "record_words": 8,
         "check": {"reads_checked_per_window": 64, "warm_windows": 2}}
SMALL_MIX = {"b-zipf": {"ops_per_step": 256}}


def make(spec, mix, seed, device, small=None) -> EngineCell:
    if spec["record_words"] * 4 != spec["record_bytes"]:
        raise ValueError("a record is record_words float32 words")
    if small:
        spec = dict(spec, **small)
    c = spec["check"]
    return EngineCell(spec, mix, seed, device, warm_windows=c["warm_windows"],
                      reads_checked=c["reads_checked_per_window"])
