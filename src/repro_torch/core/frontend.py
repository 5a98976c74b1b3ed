"""The HADES frontend — the public API of the paper's system (port of
`repro/core/frontend.py`).

`Hades` wires the pieces together as Figure 4 draws them:

    application --alloc/read/write/free--> pool (object table + heaps)
                                              |
                      every collect_every ops: arm -> collect (Object
                      Collector, MIAD, MADV_COLD candidates)
                                              |
                 superblock stats (page-level view only) + bstate
                                              v
                      backend.make(name).step — any registered backend

It is a thin per-op wrapper over `core/engine.py`: every op is one
`Engine.step`, with the collect + backend pass fused into the op that
closes a window (the host keeps the op clock), so it runs the same
transitions as `Engine.run_window`. Batched callers drive the engine
directly. `free` advances the window clock like every other op.

The pool's `data` is updated in place, so `self.state` is reassigned from
every op's result and the previous state is never touched again; a
holder of `h.state` re-reads it after any op.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import engine as eng
from repro_torch.core import object_table as ot
from repro_torch.core import page_util
from repro_torch.core import pool as pl

# the same class: its fields and defaults
HadesOptions = eng.EngineOptions


def clear_load_phase(state: Dict) -> Dict:
    """What `Hades.end_load_phase` does to the pool state: clear the
    access bits, ATCs, referenced bits and window counters without
    classifying (allocation stores are not workload accesses)."""
    zero = torch.zeros((), dtype=torch.int32, device=state["table"].device)
    return dict(state,
                table=ot.clear_access_and_atc(state["table"]),
                slot_ref=torch.zeros_like(state["slot_ref"]),
                win_accesses=zero, win_promos=zero.clone(),
                win_faults=zero.clone())


def heap_histogram(state: Dict) -> Dict[str, int]:
    """Live objects per heap (NEW / HOT / COLD)."""
    h, live = ot.heap_of(state["table"]), ot.is_live(state["table"])
    return {name: int((live & (h == hid)).sum())
            for name, hid in (("new", ot.NEW), ("hot", ot.HOT),
                              ("cold", ot.COLD))}


class Hades:
    """One managed pool and its collector / backend loop. `device` follows
    the port's rule: the card unless "cpu" is asked for."""

    def __init__(self, pool_cfg: pl.PoolConfig,
                 opts: Optional[HadesOptions] = None, device=None):
        self.cfg = pool_cfg
        self.opts = opts or HadesOptions()
        self.engine = eng.Engine(pool_cfg, self.opts, device=device)
        self.device = self.engine.device
        self.state = self.engine.init()
        self._step = 0
        self.last_report: Dict[str, torch.Tensor] = {}

    # -- window clock (the host's copy of the cadence) ------------------------
    def _flags(self):
        if not self.opts.enabled:
            return False, False
        nxt = self._step + 1
        every = self.opts.collect_every
        do_arm = self.opts.overlap_collect and nxt % every == every - 1
        do_collect = nxt % every == 0
        return do_arm, do_collect

    def _op(self, op: str, obj_ids, values=None):
        do_arm, do_collect = self._flags()
        self.state, out, report = self.engine.step(
            self.state, op, obj_ids, values, do_arm=do_arm,
            do_collect=do_collect)
        self._step += 1
        if do_collect:
            self.last_report = report
        return out

    # -- application-facing ops -----------------------------------------------
    def alloc(self, obj_ids, values):
        self._op("alloc", obj_ids, values)

    def read(self, obj_ids) -> torch.Tensor:
        return self._op("read", obj_ids)

    def write(self, obj_ids, values):
        self._op("write", obj_ids, values)

    def free(self, obj_ids):
        self._op("free", obj_ids)

    def end_load_phase(self):
        """Start the run with a fresh observation window: clear load-time
        access bits and window counters without classifying."""
        self.state = clear_load_phase(self.state)
        self._step = 0

    # -- collector / backend loop -----------------------------------------------
    def collect(self):
        """Force a collect + backend pass now."""
        self.state, self.last_report = self.engine.collect_now(self.state)

    # -- metrics ------------------------------------------------------------------
    def rss_bytes(self) -> int:
        return int(pl.rss_bytes(self.cfg, self.state))

    def host_bytes(self) -> int:
        return int(pl.host_bytes(self.cfg, self.state))

    def page_utilization(self) -> float:
        return float(page_util.from_pool(self.cfg, self.state))

    def heap_histogram(self) -> Dict[str, int]:
        return heap_histogram(self.state)

    def counters(self) -> Dict[str, int]:
        s = self.state
        return {"faults": int(s["total_faults"]),
                "moves": int(s["total_moves"]),
                "epoch": int(s["epoch"]),
                "ciw_threshold": float(s["ciw_threshold"])}
