"""SimHeap — byte-granular virtual-address-space simulator (port of
`repro/core/simheap.py`).

The pool (`core/pool.py`) manages fixed-size framework objects. The
paper's evaluation is about C++ heaps: variable-size objects (30 B keys,
1024 B values, index nodes), 4 KiB pages, 2 MiB huge pages, kswapd/madvise
backends. SimHeap reproduces that environment: it tracks *placement*
(addresses), not payloads, in numpy, as the JAX package does.

Semantics mirrored from HADES:
  * three heaps as contiguous address ranges (NEW / HOT / COLD);
  * bump allocation + collector-time compaction;
  * per-object access bit / CIW / ATC, the same state machine;
  * MIAD feedback on the COLD-heap promotion rate;
  * page-level backends that see only page metadata — the port's
    `core.backend` registry, with a 4 KiB page in the superblock's role
    (`PageGeometry`). `backend_step` hands the page stats to the backend
    as tensors on the SimHeap's `device` (the card unless "cpu" is asked
    for) and writes its tier and evict columns back as numpy; stateful
    backends carry their state on that device across windows;
  * page faults promote pages back and cost `fault_ns`;
  * huge-page promotion of dense 2 MiB runs in the HOT heap.

Cost model (fig 6c): every tracked access pays `track_ns`; the first
observation of an object in a window pays the scope-guard O(log N) term;
faults pay `fault_ns`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as be
from repro_torch.core import pool as pl
from repro_torch.device import resolve_device

NEW, HOT, COLD = 0, 1, 2
PAGE = 4096
HUGE = 2 * 1024 * 1024
ALIGN = 16


def _unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a) (the sorted distinct values) by one sort. The hash
    table behind the np.unique of newer numpy releases took about a third
    of a 10 M-key CrestKV window on an H100 machine's host
    (tools/crest_profile.py)."""
    s = np.sort(a)
    return s[np.concatenate(([True], s[1:] != s[:-1]))] if len(s) else s


@dataclasses.dataclass
class SimConfig:
    max_objects: int
    heap_bytes: int                 # per-heap address range
    backend: str = "reactive"       # any registered backend.names() entry
    hbm_target_bytes: int = 0       # pressure target / promote watermark
    ciw_threshold: float = 3.0
    ciw_min: float = 1.0
    ciw_max: float = 16.0
    promotion_target: float = 0.01
    miad_mult: float = 2.0
    miad_add: float = 1.0
    calm_required: int = 2
    enabled: bool = True            # False = no tidying (baseline layout)
    track_ns: float = 4.5           # access-bit SET (paper: 4-5 ns, L1-ish)
    check_ns: float = 0.5           # already-set fast path ("skip if set")
    guard_ns: float = 1.0           # scope-guard cost per log2(N) level
    fault_ns: float = 15_000.0      # SSD swap fault (P4800x-class)
    base_op_ns: float = 1_500.0     # baseline cost of one KV op (CrestDB)
    huge_occupancy: float = 0.90    # hugepage promotion threshold


class SimHeap:
    """Trace-driven address-space engine. All ops are vectorized."""

    def __init__(self, cfg: SimConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        n = cfg.max_objects
        self.addr = np.full(n, -1, np.int64)       # byte address
        self.size = np.zeros(n, np.int64)
        self.heap = np.full(n, -1, np.int8)        # -1 = free
        self.access = np.zeros(n, bool)
        self.ciw = np.zeros(n, np.int16)
        self.atc = np.zeros(n, np.int16)
        self.armed = False
        # bump cursors per heap (addresses are heap-relative + heap base)
        self.base = {NEW: 0, HOT: cfg.heap_bytes, COLD: 2 * cfg.heap_bytes}
        self.cursor = {NEW: 0, HOT: 0, COLD: 0}
        self.live_bytes = {NEW: 0, HOT: 0, COLD: 0}
        # page metadata over the whole 3-heap address space
        self.n_pages = (3 * cfg.heap_bytes) // PAGE
        self.resident = np.zeros(self.n_pages, bool)
        self.referenced = np.zeros(self.n_pages, bool)
        self.evict = np.zeros(self.n_pages, np.int8)  # 0/1 cand/2 out
        # shared tiering backend (core.backend registry): a 4 KiB page
        # plays the superblock role; unknown names fail HERE, at
        # construction. `reactive` runs in strict-kswapd mode (never
        # evicts referenced pages — the simulator's historical ceiling).
        self._geom = be.PageGeometry(n_sbs=self.n_pages, sb_bytes=PAGE)
        self.backend = self._make_backend(cfg)
        self._bstate = self.backend.init(self._geom, self.device)
        # MIAD state
        self.ciw_threshold = cfg.ciw_threshold
        self.calm_windows = 0
        self.proactive_ok = False
        # window + lifetime counters
        self.win_accesses = 0
        self.win_promos = 0
        self.win_first_obs = 0
        self.win_faults = 0
        self.win_track_ops = 0
        self.epoch = 0
        self.total_faults = 0
        self.total_moves = 0
        self.total_ns = 0.0
        self.window_log: list = []

    # -- allocation ---------------------------------------------------------
    def alloc(self, ids: np.ndarray, sizes: np.ndarray,
              heap: int = NEW) -> None:
        """Bump-allocate objects into `heap` (NEW unless placing an
        un-tidied baseline, which scatters everything into one heap)."""
        ids = np.asarray(ids, np.int64)
        sizes = np.asarray(sizes, np.int64)
        aligned = (sizes + ALIGN - 1) // ALIGN * ALIGN
        offs = np.cumsum(aligned) - aligned
        start = self.cursor[heap]
        need = int(offs[-1] + aligned[-1]) if len(ids) else 0
        if start + need > self.cfg.heap_bytes:
            self._compact(heap)
            start = self.cursor[heap]
            if start + need > self.cfg.heap_bytes:
                raise MemoryError(f"heap {heap} exhausted")
        addrs = self.base[heap] + start + offs
        self.addr[ids] = addrs
        self.size[ids] = sizes
        self.heap[ids] = heap
        self.access[ids] = True
        self.ciw[ids] = 0
        self.cursor[heap] = start + need
        self.live_bytes[heap] += int(aligned.sum())
        self._touch_pages(addrs, sizes, fault=True)
        self.win_accesses += len(ids)

    def free(self, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        ids = ids[self.heap[ids] >= 0]
        aligned = (self.size[ids] + ALIGN - 1) // ALIGN * ALIGN
        for h in (NEW, HOT, COLD):
            self.live_bytes[h] -= int(aligned[self.heap[ids] == h].sum())
        self.heap[ids] = -1
        self.addr[ids] = -1

    # -- access (the dereference) --------------------------------------------
    def access_objects(self, ids: np.ndarray) -> None:
        """Record accesses (duplicates allowed — dedup is the 'skip if
        already set' fast path)."""
        ids = np.asarray(ids, np.int64)
        ids = ids[self.heap[ids] >= 0]
        if len(ids) == 0:
            return
        uniq = _unique(ids)
        newly = ~self.access[uniq]
        self.win_first_obs += int(newly.sum())
        self.access[uniq] = True
        if self.armed:
            np.add.at(self.atc, ids, 1)
        self.win_promos += int((self.heap[uniq] == COLD).sum())
        self.win_accesses += len(ids)
        self.win_track_ops += len(ids)
        self._touch_pages(self.addr[uniq], self.size[uniq], fault=True)

    @staticmethod
    def _page_ranges(addrs: np.ndarray, sizes: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Expand per-object [first, last] page spans into one flat page
        array + the object index each entry came from. Ragged-range via
        repeat/cumsum: O(total touched pages), independent of the max
        object span (the old per-span Python loop was O(max span) full
        passes over the batch)."""
        first = addrs // PAGE
        last = (addrs + np.maximum(sizes, 1) - 1) // PAGE
        counts = (last - first + 1).astype(np.int64)
        owner = np.repeat(np.arange(len(addrs)), counts)
        # offset within each object's span: global arange minus each
        # span's starting position, broadcast by repeat
        starts = np.cumsum(counts) - counts
        offs = np.arange(counts.sum(), dtype=np.int64) - np.repeat(starts,
                                                                   counts)
        return np.repeat(first, counts) + offs, owner

    def _touch_pages(self, addrs: np.ndarray, sizes: np.ndarray,
                     fault: bool) -> None:
        if len(addrs) == 0:
            return
        pages, _ = self._page_ranges(addrs, sizes)
        pages = _unique(pages)
        out = pages[self.evict[pages] == 2]
        self.win_faults += len(out)
        self.total_faults += len(out)
        self.evict[pages] = 0
        self.resident[pages] = True
        self.referenced[pages] = True

    # -- collector ------------------------------------------------------------
    def arm(self) -> None:
        self.armed = True

    def collect(self) -> Dict[str, float]:
        """Object Collector pass: CIW update, classification, migration,
        compaction, MIAD, backend handoff signals."""
        cfg = self.cfg
        live = self.heap >= 0
        acc = self.access & live
        self.ciw[acc] = 0
        idle = live & ~self.access
        self.ciw[idle] = np.minimum(self.ciw[idle] + 1, 31)

        report = {"promotion_rate": self.promotion_rate(),
                  "epoch": self.epoch}
        if cfg.enabled:
            ct = math.floor(self.ciw_threshold)
            movable = self.atc == 0
            to_hot = acc & ((self.heap == NEW) | (self.heap == COLD)) & \
                movable
            to_cold = idle & (self.ciw > ct) & \
                ((self.heap == NEW) | (self.heap == HOT)) & movable
            self._migrate(np.nonzero(to_hot)[0], HOT)
            self._migrate(np.nonzero(to_cold)[0], COLD)
            report["moved_to_hot"] = int(to_hot.sum())
            report["moved_to_cold"] = int(to_cold.sum())
            # Compact NEW/HOT when >30% holes. The COLD heap is NEVER
            # compacted in normal operation: its pages may be paged out,
            # and touching them would fault the whole point away. It is
            # compacted only on emergency (migration target full), with
            # the fault cost charged honestly (_compact counts them).
            for h in (NEW, HOT):
                if self.cursor[h] > 1.3 * max(self.live_bytes[h], 1):
                    self._compact(h)

        # MIAD
        rate = self.promotion_rate()
        if rate > cfg.promotion_target:
            self.ciw_threshold = min(self.ciw_threshold * cfg.miad_mult,
                                     cfg.ciw_max)
            self.calm_windows = 0
        else:
            self.ciw_threshold = max(self.ciw_threshold - cfg.miad_add,
                                     cfg.ciw_min)
            self.calm_windows += 1
        self.proactive_ok = self.calm_windows >= cfg.calm_required

        # frontend -> backend signal: fully-cold COLD-heap pages -> MADV_COLD
        if cfg.enabled:
            lo = self.base[COLD] // PAGE
            hi = (self.base[COLD] + self.cursor[COLD]) // PAGE + 1
            cand = self.resident[lo:hi] & ~self.referenced[lo:hi] & \
                (self.evict[lo:hi] == 0)
            self.evict[lo:hi][cand] = 1

        # window accounting -> overhead model. Instrumentation costs apply
        # only when HADES is enabled (no tracking in the baseline); fault
        # penalties always apply (they are the backend's, not HADES').
        ns = self.win_faults * cfg.fault_ns
        if cfg.enabled:
            log_n = max(math.log2(max(int(live.sum()), 2)), 1.0)
            ns += (self.win_first_obs * (cfg.track_ns + cfg.guard_ns * log_n)
                   + (self.win_track_ops - self.win_first_obs) * cfg.check_ns)
        self.total_ns += ns
        report.update(window_overhead_ns=ns, faults=self.win_faults,
                      accesses=self.win_accesses,
                      page_utilization=self.page_utilization(),
                      rss_bytes=self.rss_bytes(),
                      ciw_threshold=self.ciw_threshold)
        self.window_log.append(report)

        # reset window state (backends act on the CLOSING window's
        # referenced bits — snapshot before clearing)
        self.last_referenced = self.referenced.copy()
        self.access[:] = False
        self.atc[:] = 0
        self.armed = False
        self.referenced[:] = False
        self.win_accesses = self.win_promos = 0
        self.win_first_obs = self.win_faults = self.win_track_ops = 0
        self.epoch += 1
        return report

    def _migrate(self, ids: np.ndarray, dest: int) -> None:
        if len(ids) == 0:
            return
        sizes = self.size[ids]
        aligned = (sizes + ALIGN - 1) // ALIGN * ALIGN
        offs = np.cumsum(aligned) - aligned
        need = int(offs[-1] + aligned[-1])
        if self.cursor[dest] + need > self.cfg.heap_bytes:
            self._compact(dest)
            if self.cursor[dest] + need > self.cfg.heap_bytes:
                return  # dest full: skip this window (forward progress)
        for h in (NEW, HOT, COLD):
            sel = self.heap[ids] == h
            self.live_bytes[h] -= int(aligned[sel].sum())
        self.addr[ids] = self.base[dest] + self.cursor[dest] + offs
        self.heap[ids] = dest
        self.cursor[dest] += need
        self.live_bytes[dest] += need
        self.total_moves += len(ids)
        self._touch_pages(self.addr[ids], sizes, fault=False)

    def _compact(self, heap: int) -> None:
        """Slide live objects to the heap base (table-mediated pointer
        rewrite — no application involvement). Compacting a region with
        paged-out pages faults them in first — charged to the window."""
        lo_pg = self.base[heap] // PAGE
        hi_pg = (self.base[heap] + self.cursor[heap]) // PAGE + 1
        paged_out = int((self.evict[lo_pg:hi_pg] == 2).sum())
        self.win_faults += paged_out
        self.total_faults += paged_out
        ids = np.nonzero(self.heap == heap)[0]
        if len(ids):
            order = np.argsort(self.addr[ids], kind="stable")
            ids = ids[order]
            aligned = (self.size[ids] + ALIGN - 1) // ALIGN * ALIGN
            offs = np.cumsum(aligned) - aligned
            self.addr[ids] = self.base[heap] + offs
            end = int(offs[-1] + aligned[-1])
        else:
            end = 0
        # the compacted prefix was written to (resident); pages beyond the
        # new cursor are free
        plo = self.base[heap] // PAGE
        pmid = (self.base[heap] + end + PAGE - 1) // PAGE
        phi = (self.base[heap] + self.cfg.heap_bytes) // PAGE
        self.resident[plo:pmid] = True
        self.evict[plo:pmid] = 0
        self.resident[pmid:phi] = False
        self.evict[pmid:phi] = 0
        self.cursor[heap] = end
        self.live_bytes[heap] = end

    # -- backend (page-level, object-oblivious) --------------------------------
    # The adapter onto the shared `core.backend` protocol: page metadata
    # in, protocol stats out, the backend's outputs applied back.
    @staticmethod
    def _make_backend(cfg: SimConfig) -> be.Backend:
        params = be.pressure_params(cfg.backend, cfg.hbm_target_bytes)
        if cfg.backend == "reactive":
            # strict kswapd: the referenced set is a hard memory ceiling
            params["evict_referenced"] = False
        return be.make(cfg.backend, **params)

    def page_stats(self) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                  np.ndarray]:
        """The backend protocol's (stats, tier, evict) view of the page
        metadata: occupied = resident or paged out; tier HOST iff paged
        out; referenced = the CLOSING window's bits (post-collect
        snapshot)."""
        out = self.evict == 2
        occ = (self.resident | out).astype(np.int32)
        ref = getattr(self, "last_referenced", self.referenced)
        region = np.full(self.n_pages, COLD, np.int8)
        for h in (NEW, HOT):
            lo = self.base[h] // PAGE
            region[lo:lo + self.cfg.heap_bytes // PAGE] = h
        tier = np.where(out, pl.HOST, pl.HBM).astype(np.int8)
        stats = {"occupancy": occ, "referenced": ref.copy(),
                 "region": region, "tier": tier, "evict": self.evict.copy()}
        return stats, tier, self.evict.astype(np.int8)

    def backend_step(self) -> None:
        stats, tier, evict = self.page_stats()
        dev = self.device

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        signals = {"proactive_ok": torch.tensor(bool(self.proactive_ok),
                                                device=dev),
                   "epoch": torch.tensor(self.epoch, dtype=torch.int32,
                                         device=dev)}
        self._bstate, tier2, evict2, _ = self.backend.step(
            self._geom, self._bstate, {k: on_dev(v) for k, v in stats.items()},
            on_dev(tier), on_dev(evict), signals)
        tier2 = tier2.cpu().numpy()
        # apply the backend's outputs verbatim: the full evict column, and
        # residency from the tier deltas
        self.evict = evict2.cpu().numpy().astype(np.int8)
        demoted = (tier == pl.HBM) & (tier2 == pl.HOST)   # paged out
        promoted = (tier == pl.HOST) & (tier2 == pl.HBM)  # re-tiered in
        self.resident[demoted] = False
        self.resident[promoted] = True

    # -- metrics ----------------------------------------------------------------
    def promotion_rate(self) -> float:
        return self.win_promos / max(self.win_accesses, 1)

    def page_utilization(self) -> float:
        """Unique accessed bytes / (touched pages x 4 KiB), this window."""
        live = (self.heap >= 0) & self.access
        if not live.any():
            return 1.0
        ids = np.nonzero(live)[0]
        ubytes = int(self.size[ids].sum())
        pages, _ = self._page_ranges(self.addr[ids], self.size[ids])
        return ubytes / (len(_unique(pages)) * PAGE)

    def per_page_utilization(self) -> np.ndarray:
        """Utilized fraction of every page touched this window (fig 2's
        CDF): accessed bytes landing on each page / 4096."""
        live = (self.heap >= 0) & self.access
        if not live.any():
            return np.ones(1)
        ids = np.nonzero(live)[0]
        addr, size = self.addr[ids], self.size[ids]
        acc = np.zeros(self.n_pages, np.int64)
        pg, owner = self._page_ranges(addr, size)
        # bytes of each owning object landing on each of its pages
        start = np.maximum(addr[owner], pg * PAGE)
        end = np.minimum(addr[owner] + size[owner], (pg + 1) * PAGE)
        np.add.at(acc, pg, np.maximum(end - start, 0))
        touched = acc[acc > 0]
        return np.minimum(touched / PAGE, 1.0)

    def rss_bytes(self) -> int:
        """Resident bytes, honouring hugepage rounding in the HOT heap:
        a 2 MiB run that crossed the occupancy threshold is counted fully
        (it is mapped as one huge page)."""
        base_rss = int(self.resident.sum()) * PAGE
        lo = self.base[HOT] // PAGE
        hi = (self.base[HOT] + self.cursor[HOT]) // PAGE + 1
        hot_pages = self.resident[lo:hi]
        per_huge = HUGE // PAGE
        n_runs = len(hot_pages) // per_huge
        if n_runs:
            runs = hot_pages[:n_runs * per_huge].reshape(n_runs, per_huge)
            occ = runs.mean(axis=1)
            promoted = occ >= self.cfg.huge_occupancy
            # promoted runs are counted fully; their sparse remainder is
            # the THP-bloat term
            bloat = int(((1 - runs[promoted].mean(axis=1)) *
                         HUGE).sum()) if promoted.any() else 0
            base_rss += bloat
        return base_rss

    def touched_bytes(self) -> int:
        live = (self.heap >= 0) & self.access
        return int(self.size[live].sum())

    def overhead_ns(self) -> float:
        return self.total_ns
