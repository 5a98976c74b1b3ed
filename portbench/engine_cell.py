"""A key-value store on the object engine as a benchmark cell:
`repro_torch.core.engine.Engine.serve_steps`, one window of YCSB steps per
call, one window in flight (a closed loop).

Set-up: the kernels (`build_all`, cached in `build/kernels/`), the pool,
the load phase (every key allocated with its payload, then the load
phase's reset), and warm-up windows of the key stream, the first of
which captures the window's CUDA graph. The keys are drawn on the device
from the seed CHUNK windows at a time, before the window that needs
them, and only the current chunk is kept: the check draws them again.

An operation's latency runs from the call that takes its window to the
return of that call with the window's reports on the host; every
operation of a window has the window's latency. After each window the
harness recounts the pool's resident bytes on the device from the slot
owners and the superblock tiers (`resident_frac`). With `trace`, windows
of the same stream after the window are profiled.

`correct` (`check`), once the window has closed: a sample of the reads
of every window, drawn from the seed, against the plain store
(`reference/kvstore.py`) replayed over the same keys and payloads; every
record read back from the final pool; the final object table, slot
owners and occupancy against a plain recount, each window's resident
bytes as the engine reports them against the harness's recount, and the
port's Page Utilization against the plain one.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import gen, tracing
from portbench.reference import kvstore

WORD_SLOT_MASK, WORD_HEAP_SHIFT, FREE_HEAP = (1 << 20) - 1, 20, 3
ACCESS_BIT = 1 << 22
LOAD_CHUNK = 65536      # keys an alloc step of the load phase
TRACE_TRIES = 3         # profiled stretches of 4 windows at most
CHUNK = 64              # windows whose keys are drawn at once


def page_utilization(table: torch.Tensor, keys: torch.Tensor,
                     page_slots: int) -> float:
    """The plain Page Utilization of the set `keys`: their bytes over the
    bytes of the pages their slots lie on (slots of equal size)."""
    uniq = torch.unique(keys.long())
    pages = torch.unique((table[uniq] & WORD_SLOT_MASK).long() // page_slots)
    return uniq.numel() / float(pages.numel() * page_slots)


class EngineCell:
    def __init__(self, spec: Dict, mix: Dict, seed: int, device, *,
                 warm_windows: int, reads_checked: int):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)
        self.warm = warm_windows
        self.n_sample = reads_checked
        self.ops = gen.ycsb_ops(mix)
        self.n_read_steps = self.ops.index("write") if "write" in self.ops \
            else len(self.ops)

    # -- set-up ---------------------------------------------------------
    def setup(self, seconds: float) -> None:
        from repro_torch.core import backend as be
        from repro_torch.core import engine as E
        from repro_torch.core import pool as pl
        from repro_torch.core.collector import CollectorConfig
        from repro_torch.core.frontend import clear_load_phase
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()
        s = self.spec
        pool = s["pool"]
        self.pcfg = pl.make_config(s["recordcount"], s["record_words"],
                                   sb_slots=pool["sb_slots"],
                                   page_slots=pool["page_slots"],
                                   slack=pool["slack"], dtype="float32")
        eo = s["engine"]
        self.eng = E.Engine(self.pcfg, E.EngineOptions(
            collect_every=eo["collect_every"], backend=be.make(eo["backend"]),
            collector=CollectorConfig(move_budget=eo["move_budget"])),
            device=str(self.device))
        if eo["collect_every"] != self.mix["steps_per_window"]:
            raise ValueError("a window must be one collect period")
        n, w = self.pcfg.max_objects, self.pcfg.slot_words
        state = self.eng.init()
        for lo in range(0, n, LOAD_CHUNK):
            ids = torch.arange(lo, min(lo + LOAD_CHUNK, n), dtype=torch.int32,
                               device=self.device)
            state, _, _ = self.eng.step(
                state, "alloc", ids, gen.payload(self.seed, ids, -1, w))
        self.state = clear_load_phase(state)
        self.stream = gen.YcsbKeys(self.mix, n, self.seed, self.device)
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)
        self.chunk = None               # (index, keys [CHUNK, steps, ops])
        self.sample_at: List[torch.Tensor] = []   # [CHUNK, n_sample] each
        self.samples: List[torch.Tensor] = []     # [CHUNK, n_sample, w]
        self.resident: List[torch.Tensor] = []    # [CHUNK] superblocks
        k = self.mix["ops_per_step"]
        self.values = torch.zeros((len(self.ops), k, w), dtype=torch.float32,
                                  device=self.device)
        self.op_codes = torch.tensor([E.OP_CODES[o] for o in self.ops],
                                     dtype=torch.int32)
        self.done = 0
        for _ in range(self.warm):
            self._window()
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _keys(self, i: int) -> torch.Tensor:
        """Window i's keys, drawing the next chunk (and its read samples'
        places) when window i opens it."""
        c, j = divmod(i, CHUNK)
        if self.chunk is None or self.chunk[0] != c:
            if c != len(self.samples):
                raise ValueError(f"window {i} out of order")
            self.chunk = (c, torch.stack([self.stream.window()
                                          for _ in range(CHUNK)]))
            k, w = self.mix["ops_per_step"], self.pcfg.slot_words
            self.sample_at.append(torch.randint(
                0, self.n_read_steps * k, (CHUNK, self.n_sample),
                generator=self.sample_gen, device=self.device))
            self.samples.append(torch.empty((CHUNK, self.n_sample, w),
                                            dtype=torch.float32,
                                            device=self.device))
            self.resident.append(torch.zeros(CHUNK, dtype=torch.int64,
                                             device=self.device))
        return self.chunk[1][j]

    def _resident_sbs(self) -> torch.Tensor:
        """Superblocks that hold an object and sit in the hot tier, counted
        on the device from the slot owners and the tiers."""
        st = self.state
        occ = (st["slot_owner"] >= 0).view(self.pcfg.n_sbs, -1).sum(1)
        return ((occ > 0) & (st["sb_tier"] == 0)).sum()

    def _window(self):
        """Window `self.done` through one `serve_steps` call; returns its
        latency and collect reports."""
        i = self.done
        ids = self._keys(i)
        for s, op in enumerate(self.ops):
            if op == "write":
                self.values[s] = gen.payload(self.seed, ids[s], i,
                                             self.pcfg.slot_words)
        trace = {"op": self.op_codes, "ids": ids, "values": self.values}
        t0 = time.perf_counter()
        self.state, outs, reps = self.eng.serve_steps(
            self.state, trace, step0=i * len(self.ops))
        dt = time.perf_counter() - t0
        flat = outs.view(-1, outs.shape[-1])
        c, j = divmod(i, CHUNK)
        self.samples[c][j] = flat[self.sample_at[c][j]]
        self.resident[c][j] = self._resident_sbs()
        self.last_report = reps[-1]
        self.done += 1
        return dt, reps

    # -- the window -----------------------------------------------------
    def run(self, seconds: float, trace: bool) -> None:
        self.profile: Optional[Dict] = None
        self.first = self.done
        self.latency: List[float] = []
        self.reports: List[Dict] = []
        self.stamps: List[float] = []
        start = time.perf_counter()
        last = 0.0
        while self.done == self.first or \
                time.perf_counter() - start + last <= seconds:
            self.stamps.append(time.perf_counter())
            last, reps = self._window()
            self.latency.append(last)
            self.reports.extend(reps)
        self._sync()
        self.stamps.append(time.perf_counter())
        self.wall = self.stamps[-1] - start
        self.measured = self.done - self.first
        if trace:
            self._trace_windows()

    def _trace_windows(self) -> None:
        """After the window has closed, windows k - 1 .. k + 2 of the same
        stream under the profiler, k and k + 1 read; again on the next
        four when the trace is not whole (a profiled stretch slows the
        windows after it too)."""
        for _ in range(TRACE_TRIES):
            k = self.done + 1
            prof = tracing.profiler()
            prof.start()
            tracing.open_trace()
            moved = []
            for _ in range(4):
                _, reps = self._window()
                moved += [r["moved_to_hot"] + r["moved_to_cold"]
                          for r in reps]
            tracing.close_trace()
            prof.stop()
            got = tracing.read_stretch(prof, k)
            if got is not None:
                self.profile = dict(got, moved=moved[1:3])
                return

    # -- numbers --------------------------------------------------------
    def ops_per_window(self) -> int:
        return len(self.ops) * self.mix["ops_per_step"]

    def resident_sbs(self) -> List[int]:
        """The recounted resident superblocks at each measured window's
        close."""
        flat = torch.cat(self.resident).tolist()
        return flat[self.first:self.first + self.measured]

    def end_to_end(self) -> Dict[str, float]:
        lat_ms = np.asarray(self.latency) * 1e3
        live = self.measured * self.pcfg.max_objects * self.pcfg.slot_bytes
        return {"ops_s": self.measured * self.ops_per_window() / self.wall,
                "op_p95_ms": float(np.percentile(lat_ms, 95)),
                "resident_frac": sum(self.resident_sbs())
                * self.pcfg.sb_bytes / live}

    def attempted(self):
        return self.measured * self.ops_per_window(), 0

    def record(self) -> Dict:
        last = self._keys(self.done - 1)[:self.n_read_steps].reshape(-1)
        table = self.state["table"]
        return {
            "slot_bytes": self.pcfg.slot_bytes,
            "n_objects": self.pcfg.max_objects, "n_sbs": self.pcfg.n_sbs,
            "move_budget": self.spec["engine"]["move_budget"],
            "windows": self.measured, "wall_s": self.wall,
            "stamps": self.stamps,
            "reports": self.reports, "profile": self.profile,
            "page_utilization": page_utilization(
                table, last, self.pcfg.page_slots),
        }

    # -- correct --------------------------------------------------------
    def release(self) -> None:
        """Take what the check reads off the program's final state (the
        table, owners, occupancy, tiers, every record in key order and the
        port's Page Utilization of the last window's reads), then free the
        engine and its pool."""
        from repro_torch.core import page_util
        st = self.state
        n = self.pcfg.max_objects
        table = st["table"]
        last = self._keys(self.done - 1)[:self.n_read_steps].reshape(-1)
        marked = table.clone()
        marked[last.long()] |= ACCESS_BIT
        self.final = {
            "table": table.clone(), "owner": st["slot_owner"].clone(),
            "sb_occ": st["sb_occ"].clone(), "sb_tier": st["sb_tier"].clone(),
            "rows": st["data"][(table[:n] & WORD_SLOT_MASK).long()].clone(),
            "pu_port": float(page_util.from_pool(
                self.pcfg, dict(st, table=marked))),
            "pu_plain": page_utilization(table, last, self.pcfg.page_slots),
            "rss": self.last_report["rss_bytes"],
            "resident": self.resident_sbs()}
        del self.state, self.eng, self.values
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def replay(self, lag: int = 0) -> int:
        """Sampled reads of every window that did not read what the plain
        store (the control: with `lag`) holds at that point."""
        w = self.pcfg.slot_words
        n = self.pcfg.max_objects
        keys = torch.arange(n, dtype=torch.int32, device=self.device)
        store = kvstore.Store(gen.payload(self.seed, keys, -1, w), lag=lag)
        k = self.mix["ops_per_step"]
        stream = gen.YcsbKeys(self.mix, n, self.seed, self.device)
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(self.done):
            ids = stream.window()
            c, j = divmod(i, CHUNK)
            at = self.sample_at[c][j]
            want = store.read(ids[at // k, at % k])
            bad += (want != self.samples[c][j]).any(1).sum()
            for s, op in enumerate(self.ops):
                if op == "write":
                    store.update(ids[s], gen.payload(self.seed, ids[s], i, w))
        self.store = store
        return int(bad)

    def table_mismatches(self) -> int:
        f = self.final
        n = self.pcfg.max_objects
        words = f["table"][:n]
        live = ((words >> WORD_HEAP_SHIFT) & 3) != FREE_HEAP
        slots = (words & WORD_SLOT_MASK).long()
        bad = int((~live).sum())
        bad += n - int(torch.unique(slots).numel())
        owner = f["owner"]
        keys = torch.arange(n, device=owner.device)
        bad += int((owner[slots] != keys).sum())
        bad += int((owner >= 0).sum()) - n
        occ = (owner >= 0).view(self.pcfg.n_sbs, -1).sum(1)
        bad += int((occ != f["sb_occ"]).sum())
        rss = int(((occ > 0) & (f["sb_tier"] == 0)).sum()) * \
            self.pcfg.sb_bytes
        bad += int(rss != f["rss"])
        bad += abs(len(f["resident"]) - len(self.reports))
        bad += sum(int(r * self.pcfg.sb_bytes != rep["rss_bytes"])
                   for r, rep in zip(f["resident"], self.reports))
        bad += int(abs(f["pu_port"] - f["pu_plain"]) > 1e-6)
        return bad

    def check(self, lag: int = 0) -> List[Dict]:
        reads = self.replay(lag)
        rows = int((self.final["rows"] != self.store.values).any(1).sum())
        return [
            {"name": "read_mismatches", "value": float(reads), "limit": 0.0},
            {"name": "record_mismatches", "value": float(rows),
             "limit": 0.0},
            {"name": "table_mismatches",
             "value": float(self.table_mismatches()), "limit": 0.0},
        ]
