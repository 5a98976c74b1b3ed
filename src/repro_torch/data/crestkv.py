"""CrestKV — the lightweight concurrent KV store of the paper's evaluation
(port of `repro/data/crestkv.py`).

CrestKV drives any of the ten Table-1 structures over a SimHeap address
space, reproducing the paper's experimental conditions:

  * load phase interleaves key/node/value allocations per insertion —
    exactly the allocation-order placement that creates hotness
    fragmentation once the access skew arrives;
  * run phase samples scrambled-zipfian YCSB ops; updates allocate fresh
    value objects and free old ones (the NEW-heap churn in fig 6a);
  * every `window_ops`, the heap arms tracking, runs the Object
    Collector, and lets the configured backend reclaim.

The structures, the key streams and the heap's placement stay on the host
in numpy, as in the JAX package; the SimHeap's backend step runs on
`device` (the card unless the caller asks for "cpu"). Value ids are
recycled in the JAX package's order (freed ids as a LIFO list), so a seed
gives the same run on either device and in either package.

Metrics mirror the paper's: per-window page utilization, RSS, promotion
rate, fault count, and an op-level time model for throughput/latency
(base op cost + access-bit tracking + scope-guard + fault penalties).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.simheap import NEW, SimConfig, SimHeap
from repro_torch.data.structures import (KEY_BYTES, VALUE_BYTES, Structure,
                                         make_structure)
from repro_torch.data.ycsb import WORKLOADS, ZipfianKeys, ops_stream


@dataclasses.dataclass
class RunStats:
    windows: List[Dict]
    ops: int
    total_ns: float
    base_ns: float
    faults: int

    @property
    def throughput_mops(self) -> float:
        return self.ops / max(self.total_ns, 1) * 1e3

    @property
    def overhead_frac(self) -> float:
        """Fractional slowdown vs the untracked baseline op cost."""
        return (self.total_ns - self.base_ns) / max(self.base_ns, 1)

    @property
    def mean_latency_ns(self) -> float:
        return self.total_ns / max(self.ops, 1)


class CrestKV:
    def __init__(self, structure: str, n_keys: int, sim_cfg: SimConfig,
                 seed: int = 0, value_bytes: int = VALUE_BYTES,
                 device=None):
        self.struct: Structure = make_structure(structure, n_keys, seed)
        self.n_keys = n_keys
        self.value_bytes = value_bytes
        self.heap = SimHeap(sim_cfg, seed, device=device)
        # value-object id management (updates churn ids)
        meta_ids, meta_sizes = self.struct.meta_objects()
        self.value_base = int(meta_ids[-1]) + 1 if len(meta_ids) else \
            self.struct.meta_base
        self.value_obj = self.value_base + np.arange(n_keys, dtype=np.int64)
        self._free_ids: List[int] = []
        self._next_id = self.value_base + n_keys
        self._load(meta_ids, meta_sizes)

    # -- load phase -----------------------------------------------------------
    def _load(self, meta_ids: np.ndarray, meta_sizes: np.ndarray) -> None:
        """Allocate metadata, then interleave (key, node, value) per
        insertion — the fragmentation-inducing baseline layout."""
        if len(meta_ids):
            self.heap.alloc(meta_ids, meta_sizes, heap=NEW)
        node_ids, node_sizes = self.struct.node_objects()
        key_ids = np.arange(self.n_keys, dtype=np.int64)
        ids = np.empty(3 * self.n_keys, np.int64)
        sizes = np.empty(3 * self.n_keys, np.int64)
        ids[0::3], ids[1::3], ids[2::3] = key_ids, node_ids, self.value_obj
        sizes[0::3] = KEY_BYTES
        sizes[1::3] = node_sizes
        sizes[2::3] = self.value_bytes
        self.heap.alloc(ids, sizes, heap=NEW)
        # Load complete: clear load-time access bits WITHOUT classifying —
        # the run starts with the paper's "initial object classification
        # phase" (fig 6a), not with a pre-classified heap.
        h = self.heap
        h.access[:] = False
        h.atc[:] = 0
        h.referenced[:] = False
        h.win_accesses = h.win_promos = 0
        h.win_first_obs = h.win_faults = h.win_track_ops = 0

    # -- run phase --------------------------------------------------------------
    def _alloc_values(self, n: int) -> np.ndarray:
        """`n` value ids: the most recently freed first (LIFO), then fresh
        ones."""
        take = min(len(self._free_ids), n)
        out = np.empty(n, np.int64)
        if take:
            out[:take] = self._free_ids[-take:]
            del self._free_ids[-take:]
        fresh = n - take
        if fresh:
            out[take:] = self._next_id + np.arange(fresh)
            self._next_id += fresh
        return out

    def run(self, workload: str, n_ops: int, *, window_ops: int = 50_000,
            batch: int = 4096, seed: int = 1, active_frac: float = 1 / 3,
            on_window=None) -> RunStats:
        """`active_frac` defaults to the paper's fig-7 working-set ratio
        (~4GB active of a 12GB footprint), scattered across the keyspace."""
        mix = WORKLOADS[workload]
        keys = ZipfianKeys(self.n_keys, seed=seed, active_frac=active_frac)
        heap = self.heap
        since_collect = 0
        ops_done = 0
        for upd, ks in ops_stream(mix, keys, n_ops, batch=batch, seed=seed):
            touched = self.struct.touched(ks, upd, self.value_obj[ks])
            heap.access_objects(touched)
            if upd.any():
                # one new value per updated key, in key order
                uk = np.unique(ks[upd])
                old = self.value_obj[uk]
                heap.free(old)
                self._free_ids.extend(old.tolist())
                new_ids = self._alloc_values(len(uk))
                heap.alloc(new_ids, np.full(len(uk), self.value_bytes,
                                            np.int64))
                self.value_obj[uk] = new_ids
            ops_done += len(ks)
            since_collect += len(ks)
            if since_collect >= window_ops:
                heap.arm()          # epoch protocol: arm, then collect
                report = heap.collect()
                heap.backend_step()
                # report RSS as the backend left it
                report["rss_bytes"] = heap.rss_bytes()
                since_collect = 0
                if on_window is not None:
                    on_window(report)
        base_ns = ops_done * heap.cfg.base_op_ns
        return RunStats(windows=list(heap.window_log), ops=ops_done,
                        total_ns=base_ns + heap.total_ns, base_ns=base_ns,
                        faults=heap.total_faults)


def default_sim_config(n_keys: int, *, backend: str = "reactive",
                       hbm_target_bytes: int = 0, enabled: bool = True,
                       value_bytes: int = VALUE_BYTES) -> SimConfig:
    """Size a SimHeap for a CrestKV instance: per-heap range fits all
    objects with 2x churn slack."""
    approx_bytes = n_keys * (KEY_BYTES + 64 + value_bytes) * 2 + (1 << 22)
    max_objects = 8 * n_keys + (1 << 16)
    return SimConfig(max_objects=max_objects, heap_bytes=approx_bytes,
                     backend=backend, hbm_target_bytes=hbm_target_bytes,
                     enabled=enabled)
