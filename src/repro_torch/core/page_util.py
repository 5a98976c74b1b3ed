"""Page Utilization — the paper's hotness-fragmentation metric (§2); port
of `repro/core/page_util.py`.

    PageUtilization(T) = TotalUniqueBytes(T) / (UniquePages(T) * PageSize)

Low values mean hot bytes are scattered thinly over many pages: the
address space is fragmented and pages are unreclaimable although mostly
cold. HADES drives the metric up by densifying hot objects.

  * `from_arrays` — exact, trace-driven, over (address, size) access
    records; numpy, a copy of the JAX package's.
  * `from_pool` — over a HadesPool window: the objects whose access bit is
    set, at the pool's page granularity; tensors on the pool's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import object_table as ot
from repro_torch.core import pool as pl


def from_arrays(addrs: np.ndarray, sizes: np.ndarray,
                page_size: int = 4096) -> float:
    """Exact Page Utilization from raw byte accesses.
    addrs/sizes: int64 arrays of access records (may repeat)."""
    if len(addrs) == 0:
        return 1.0
    addrs = np.asarray(addrs, np.int64)
    sizes = np.asarray(sizes, np.int64)
    # unique bytes: merge [addr, addr+size) intervals
    order = np.argsort(addrs, kind="stable")
    a = addrs[order]
    e = a + sizes[order]
    run_end = np.maximum.accumulate(e)
    new_run = np.ones(len(a), bool)
    new_run[1:] = a[1:] > run_end[:-1]
    run_id = np.cumsum(new_run) - 1
    starts = a[new_run]
    ends = np.zeros(run_id.max() + 1, np.int64)
    np.maximum.at(ends, run_id, e)
    unique_bytes = int(np.sum(ends - starts))
    # unique pages touched by any record
    first_pg = a // page_size
    last_pg = (e - 1) // page_size
    max_span = int(np.max(last_pg - first_pg)) + 1
    pages = np.concatenate([
        np.unique(np.minimum(first_pg + i, last_pg))
        for i in range(max_span)])
    unique_pages = len(np.unique(pages))
    return unique_bytes / float(unique_pages * page_size)


def from_pool(cfg: pl.PoolConfig, state: Dict) -> torch.Tensor:
    """Window Page Utilization over a HadesPool: objects whose access bit is
    set, at `cfg.page_slots` page granularity. A 0-d float32 tensor; reads
    no device value on the host."""
    tbl = state["table"]
    acc = (ot.access_of(tbl) == 1) & ot.is_live(tbl)
    n_pages = cfg.n_slots // cfg.page_slots
    page = ot.slot_of(tbl) // cfg.page_slots
    touched = ot.hit_mask(n_pages, torch.where(acc, page, n_pages))
    unique_bytes = acc.sum().to(torch.float32) * cfg.slot_bytes
    page_bytes = touched.sum().to(torch.float32) * cfg.page_slots \
        * cfg.slot_bytes
    return unique_bytes / torch.clamp(page_bytes, min=1.0)
