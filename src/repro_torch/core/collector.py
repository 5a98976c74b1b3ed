"""Object Collector — periodic scan + lock-free migration (paper §4); port
of `repro/core/collector.py`, with the region repack `compact_heap`.

Each collect pass, run between application steps:

  1. one sweep over the table words (the `access_scan` kernel on the card,
     its plain version on the CPU): CIW update and the Fig. 5 masks
        accessed & heap in {NEW, COLD}              -> migrate to HOT
        ~accessed & CIW > C_t & heap in {NEW, HOT}  -> migrate to COLD
     with the lock-free rule folded in (an object with ATC > 0 never moves)
  2. a fused two-direction migration under `move_budget`: HOT destinations
     then COLD destinations come off the free rings (so cold movers can
     claim slots hot movers vacate), then every payload copy runs as ONE
     data movement (the `migrate` kernel, which reads every source before
     it writes any destination)
  3. MIAD updates C_t; uniformly cold COLD superblocks become MADV_COLD
     candidates; access bits and ATCs clear; the epoch advances.

Inside a window program the pass stamps the span recorder's segments
(`repro_torch/spans.py`): "collect.classify", "collect.plan" and
"collect.add_drop" (the move plan's two `ot.add_drop` calls, each
direction), "collect.migrate" (the copy and the restock) and
"collect.policy" (MIAD, the superblock stats and the clears); outside one
the stamps do nothing.

The JAX package routes the sweep and the copy through its Pallas kernels
only behind `CollectorConfig.use_pallas`; both of its paths are
bit-identical, and here a CUDA tensor always goes through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import spans
from repro_torch.core import freelist as fl
from repro_torch.core import object_table as ot
from repro_torch.core import policy
from repro_torch.core import pool as pl
from repro_torch.kernels import ops as kops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CollectorConfig:
    miad: policy.MiadConfig = dataclasses.field(
        default_factory=policy.MiadConfig)
    # NEW objects migrate on their first classification
    promote_new_on_access: bool = True
    # max migrations per direction per collect; movers beyond it retry
    # next window. 0 = unbounded.
    move_budget: int = 256


def classify(pool_cfg: pl.PoolConfig, col_cfg: CollectorConfig,
             state: Dict):
    """One sweep over the table. Returns (table_with_new_ciw, to_hot,
    to_cold, skipped_atc)."""
    tbl = state["table"]
    # with_hist=False: the carried slot_ref bits already hold the per-slot
    # referenced view
    new_tbl, to_hot, to_cold, _, skipped = kops.access_scan(
        tbl, state["ciw_threshold"], sb_slots=pool_cfg.sb_slots,
        n_sbs=pool_cfg.n_sbs, with_hist=False)
    if not col_cfg.promote_new_on_access:
        to_hot = to_hot & (ot.heap_of(tbl) != ot.NEW)
    return new_tbl, to_hot, to_cold, skipped


def _select_movers(to_hot, to_cold, m: int):
    """Compress the two mover masks [n] into fixed-size id lists [m]
    (ascending id, first m win) with ONE sort. Returns (ids_hot, ok_hot,
    ids_cold, ok_cold)."""
    n = to_hot.shape[0]
    dev = to_hot.device
    idx = torch.arange(n, dtype=_I32, device=dev)
    key = torch.where(to_hot, idx, torch.where(to_cold, idx + n, idx + 2 * n))
    skey = torch.sort(key).values
    n_hot = to_hot.sum(dtype=_I32)
    n_cold = to_cold.sum(dtype=_I32)
    j = torch.arange(m, dtype=_I32, device=dev)
    ok_h = j < n_hot
    ids_h = torch.where(ok_h, skey[torch.clamp(j, max=n - 1).long()], 0)
    ok_c = j < n_cold
    ids_c = torch.where(ok_c, skey[torch.clamp(n_hot + j, 0, n - 1).long()]
                        - n, 0)
    return ids_h, ok_h, ids_c, ok_c


def _plan_moves(cfg: pl.PoolConfig, state: Dict, ids_m, ok_m,
                dest_heap: int):
    """Assign destination slots in `dest_heap`'s region to the movers
    `ids_m[ok_m]` (movers that find the region full are dropped and retry
    next window). Metadata only; the payload copy is deferred to the fused
    mover. Returns (state, src, dst, ok)."""
    tbl = state["table"]
    ids_l = ids_m.long()
    words_m = tbl[ids_l]
    src = ot.slot_of(words_m)
    dst, ok_pop, head, count = fl.pop_region(
        cfg, state["free_q"], state["free_head"], state["free_count"],
        dest_heap, ok_m)
    ok = ok_m & ok_pop
    dst = torch.where(ok, dst, src)
    n_slots = cfg.n_slots

    owner = ot.set_drop(state["slot_owner"],
                        torch.where(ok, src, n_slots).long(), -1)
    owner = ot.set_drop(owner, torch.where(ok, dst, n_slots).long(), ids_m)
    new_words = ot.with_heap(ot.with_slot(words_m, dst), dest_heap)
    tbl = ot.set_drop(tbl, torch.where(ok, ids_m, cfg.max_objects).long(),
                      new_words)
    free_q, head, count = fl.push(cfg, state["free_q"], head, count, src, ok)
    spans.stamp("collect.plan")
    sb_occ = ot.add_drop(state["sb_occ"], torch.where(
        ok, src // cfg.sb_slots, cfg.n_sbs).long(), -1)
    sb_occ = ot.add_drop(sb_occ, torch.where(
        ok, dst // cfg.sb_slots, cfg.n_sbs).long(), 1)
    spans.stamp("collect.add_drop")
    ref_src = state["slot_ref"][torch.clamp(src, 0, n_slots - 1).long()]
    slot_ref = ot.set_drop(state["slot_ref"],
                           torch.where(ok, src, n_slots).long(), False)
    slot_ref = ot.set_drop(slot_ref, torch.where(ok, dst, n_slots).long(),
                           ref_src)
    state = dict(state, table=tbl, slot_owner=owner, free_q=free_q,
                 free_head=head, free_count=count, sb_occ=sb_occ,
                 slot_ref=slot_ref)
    spans.stamp("collect.plan")
    return state, src, dst, ok


def migrate(cfg: pl.PoolConfig, state: Dict, to_hot, to_cold, *,
            move_budget: int = 256):
    """Fused two-direction migration: select budgeted movers (one sort),
    plan HOT then COLD destinations off the free rings, then run every
    payload copy as ONE in-place data movement over the pool, and restock
    the rings from the post-move owner array. Returns (state, n_hot,
    n_cold)."""
    m = int(move_budget) or cfg.max_objects
    m = max(1, min(m, cfg.max_objects))
    ids_h, okm_h, ids_c, okm_c = _select_movers(to_hot, to_cold, m)
    state, src_h, dst_h, ok_h = _plan_moves(cfg, state, ids_h, okm_h, ot.HOT)
    state, src_c, dst_c, ok_c = _plan_moves(cfg, state, ids_c, okm_c,
                                            ot.COLD)
    data = kops.migrate(state["data"], torch.cat([src_h, src_c]),
                        torch.cat([dst_h, dst_c]), torch.cat([ok_h, ok_c]))
    free_q, free_head, free_count = fl.restock(cfg, state["free_q"],
                                               state["slot_owner"])
    state = dict(state, data=data, free_q=free_q, free_head=free_head,
                 free_count=free_count)
    n_hot, n_cold = ok_h.sum(dtype=_I32), ok_c.sum(dtype=_I32)
    spans.stamp("collect.migrate")
    return state, n_hot, n_cold


def collect(pool_cfg: pl.PoolConfig, col_cfg: CollectorConfig,
            state: Dict) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One Object Collector pass. Returns (state, report)."""
    new_tbl, to_hot, to_cold, skipped_atc = classify(pool_cfg, col_cfg,
                                                     state)
    state = dict(state, table=new_tbl)
    spans.stamp("collect.classify")
    state, n_hot, n_cold = migrate(pool_cfg, state, to_hot, to_cold,
                                   move_budget=col_cfg.move_budget)

    new_ct, calm, rate, proactive_ok = policy.update(
        col_cfg.miad, state["ciw_threshold"], state["calm_windows"],
        state["win_promos"], state["win_accesses"])

    # uniformly cold COLD-region superblocks become MADV_COLD candidates
    stats = pl.superblock_stats(pool_cfg, state)
    cold_uniform = (stats["region"] == ot.COLD) & (stats["occupancy"] > 0) \
        & (~stats["referenced"]) & (state["sb_tier"] == pl.HBM)
    sb_evict = torch.where(cold_uniform & (state["sb_evict"] == pl.NORMAL),
                           pl.CANDIDATE, state["sb_evict"])

    # stats above are PRE-clear: backends see the closing window's
    # referenced bits
    report = {
        "moved_to_hot": n_hot, "moved_to_cold": n_cold,
        "skipped_atc": skipped_atc,
        "promotion_rate": rate, "proactive_ok": proactive_ok,
        "ciw_threshold": new_ct,
        "win_accesses": state["win_accesses"],
        "win_faults": state["win_faults"],
        "sb_stats": dict(stats, evict=sb_evict),
    }
    zero = torch.zeros((), dtype=_I32, device=new_tbl.device)
    state = dict(
        state, table=ot.clear_access_and_atc(state["table"]),
        sb_evict=sb_evict, ciw_threshold=new_ct, calm_windows=calm,
        epoch=state["epoch"] + 1,
        slot_ref=torch.zeros_like(state["slot_ref"]),
        armed=torch.zeros_like(state["armed"]),
        win_accesses=zero, win_promos=zero, win_faults=zero,
        total_moves=state["total_moves"] + n_hot + n_cold)
    spans.stamp("collect.policy")
    return state, report


def arm(state: Dict) -> Dict:
    """Arm the migration window: later reads bump ATCs."""
    return dict(state, armed=torch.ones_like(state["armed"]))


def compact_heap(pool_cfg: pl.PoolConfig, state: Dict, heap: int) -> Dict:
    """Repack region `heap` densely: live objects to the region's start in
    slot order, holes to its end. Every moved row is read before any is
    written (one gather, then one scatter into `data` in place). A
    maintenance pass, not on the serve path: the free rings are restocked
    from the compacted owner array and the occupancy is recounted."""
    lo, hi = pool_cfg.region(heap)
    n_slots = pool_cfg.n_slots
    owner = state["slot_owner"]
    seg = owner[lo:hi]
    live = seg >= 0
    new_rel = torch.where(live, torch.cumsum(live.to(_I32), 0, dtype=_I32)
                          - 1, -1)
    src = torch.arange(lo, hi, dtype=_I32, device=seg.device)
    # dead entries copy the all-zero scratch row onto itself
    data = state["data"]
    rows = data[torch.where(live, src, n_slots).long()]
    data[torch.where(live, new_rel + lo, n_slots).long()] = rows
    sink = torch.where(live, new_rel, hi - lo).long()
    owner = owner.clone()
    owner[lo:hi] = ot.set_drop(torch.full_like(seg, -1), sink, seg)
    tbl = ot.set_drop(
        state["table"], torch.where(live, seg, pool_cfg.max_objects).long(),
        ot.with_slot(state["table"][torch.clamp(seg, min=0).long()],
                     new_rel + lo))
    slot_ref = state["slot_ref"].clone()
    seg_ref = slot_ref[lo:hi]
    slot_ref[lo:hi] = ot.set_drop(torch.zeros_like(seg_ref), sink, seg_ref)
    free_q, free_head, free_count = fl.restock(pool_cfg, state["free_q"],
                                               owner)
    return dict(state, data=data, slot_owner=owner, table=tbl,
                slot_ref=slot_ref, free_q=free_q, free_head=free_head,
                free_count=free_count,
                sb_occ=pl.recompute_sb_occupancy(pool_cfg, owner))
