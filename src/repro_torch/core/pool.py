"""HadesPool — the managed object heap of fixed-size objects (port of
`repro/core/pool.py`).

Address-space layout (slot indices):

    [0 .............. new_end) NEW   heap  — fresh allocations
    [new_end ........ hot_end) HOT   heap  — dense, "huge-page" region
    [hot_end ........ n_slots) COLD  heap  — uniform-cold, reclaim target

Regions are superblock-aligned; a superblock (`sb_slots` contiguous slots)
is the unit backends reclaim. The pool state is a dict of tensors with the
JAX package's keys and semantics. `data` is updated IN PLACE (the JAX code
donates the carry; copying the pool per op would cost O(n_slots)); the
small metadata tensors are replaced functionally.

Tier model: sb_tier 0 = HBM, 1 = HOST; sb_evict 0 = NORMAL, 1 = CANDIDATE
(MADV_COLD), 2 = PAGED_OUT. Reading a slot whose superblock is on HOST is
a page fault: the superblock returns to HBM and the fault counter ticks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core import freelist as fl
from repro_torch.core import object_table as ot

HBM, HOST = 0, 1
NORMAL, CANDIDATE, PAGED_OUT = 0, 1, 2

_I32 = torch.int32


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static geometry."""
    max_objects: int
    slot_words: int            # elements per object slot
    sb_slots: int              # slots per superblock (reclamation unit)
    page_slots: int            # slots per 4-KiB-analog page (metric unit)
    new_sbs: int
    hot_sbs: int
    cold_sbs: int
    dtype: str = "float32"
    word_bytes: int = 4

    @property
    def n_sbs(self) -> int:
        return self.new_sbs + self.hot_sbs + self.cold_sbs

    @property
    def n_slots(self) -> int:
        return self.n_sbs * self.sb_slots

    @property
    def sb_bytes(self) -> int:
        return self.sb_slots * self.slot_words * self.word_bytes

    @property
    def slot_bytes(self) -> int:
        return self.slot_words * self.word_bytes

    def region(self, heap: int) -> Tuple[int, int]:
        """[start, end) slot range of a heap region."""
        new_end = self.new_sbs * self.sb_slots
        hot_end = new_end + self.hot_sbs * self.sb_slots
        if heap == ot.NEW:
            return 0, new_end
        if heap == ot.HOT:
            return new_end, hot_end
        if heap == ot.COLD:
            return hot_end, self.n_slots
        raise ValueError(heap)

    def sb_region_ids(self, device=None) -> torch.Tensor:
        """Per-superblock heap-region id [n_sbs] int8."""
        return _region_ids(self, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _region_ids(cfg: PoolConfig, device: torch.device) -> torch.Tensor:
    # cached: a tensor built from a Python list is a host-to-device copy
    return torch.tensor([ot.NEW] * cfg.new_sbs + [ot.HOT] * cfg.hot_sbs
                        + [ot.COLD] * cfg.cold_sbs, dtype=torch.int8,
                        device=device)


def make_config(max_objects: int, slot_words: int, *, sb_slots: int = 64,
                page_slots: int = 8, new_frac: float = 0.125,
                hot_frac: float = 0.375, slack: float = 1.5,
                dtype: str = "float32") -> PoolConfig:
    """Size a pool with `slack`x physical slots over max_objects, split into
    NEW/HOT/COLD regions by fraction.

    Raises ValueError when the pool would have more than `ot.MAX_SLOTS`
    (2^20) slots: a table word keeps the slot in 20 bits, so the slots
    above it cannot be addressed. The JAX package does not check this and
    silently wraps such slots onto low ones."""
    n_slots = int(max_objects * slack)
    n_sbs = max(3, -(-n_slots // sb_slots))
    new_sbs = max(1, int(n_sbs * new_frac))
    hot_sbs = max(1, int(n_sbs * hot_frac))
    cold_sbs = max(1, n_sbs - new_sbs - hot_sbs)
    total = (new_sbs + hot_sbs + cold_sbs) * sb_slots
    if total > ot.MAX_SLOTS:
        raise ValueError(f"{total} slots: a table word addresses at most "
                         f"{ot.MAX_SLOTS}")
    word_bytes = torch_dtype(dtype).itemsize
    return PoolConfig(max_objects=max_objects, slot_words=slot_words,
                      sb_slots=sb_slots, page_slots=page_slots,
                      new_sbs=new_sbs, hot_sbs=hot_sbs, cold_sbs=cold_sbs,
                      dtype=dtype, word_bytes=word_bytes)


def init(cfg: PoolConfig, device=None) -> Dict:
    """Fresh pool state. `data` carries one extra row (index `n_slots`), a
    permanent scratch row that is all-zero at rest: masked writes that
    target it write zeros, and the migrate kernel skips masked moves."""
    free_q, free_head, free_count = fl.seed(cfg, device)

    def zi():
        return torch.zeros((), dtype=_I32, device=device)
    return {
        "data": torch.zeros((cfg.n_slots + 1, cfg.slot_words),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "table": ot.make_table(cfg.max_objects, device),
        "slot_owner": torch.full((cfg.n_slots,), -1, dtype=_I32,
                                 device=device),
        "free_q": free_q,
        "free_head": free_head,
        "free_count": free_count,
        "sb_occ": torch.zeros(cfg.n_sbs, dtype=_I32, device=device),
        "slot_ref": torch.zeros(cfg.n_slots, dtype=torch.bool, device=device),
        "sb_tier": torch.zeros(cfg.n_sbs, dtype=torch.int8, device=device),
        "sb_evict": torch.zeros(cfg.n_sbs, dtype=torch.int8, device=device),
        # MIAD-controlled demotion threshold C_t (float32 for mult. updates)
        "ciw_threshold": torch.tensor(3.0, dtype=torch.float32,
                                      device=device),
        "calm_windows": zi(),
        "epoch": zi(),
        "armed": torch.zeros((), dtype=torch.bool, device=device),
        "win_accesses": zi(),
        "win_promos": zi(),
        "win_faults": zi(),
        "total_faults": zi(),
        "total_moves": zi(),
        "bstate": {},
    }


OP_READ, OP_WRITE, OP_ALLOC, OP_FREE = 0, 1, 2, 3


def heap_of_slot(cfg: PoolConfig, slot: torch.Tensor) -> torch.Tensor:
    """Region id a physical slot belongs to (static boundaries), int32."""
    return fl.region_of_slot(cfg, slot)


def apply_op(cfg: PoolConfig, state: Dict, op: int, obj_ids: torch.Tensor,
             values: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """One pool op (read / write / alloc / free) over a batch of ids [k]
    (ids < 0 are padding). Returns (state, read_vals [k, W]; zeros for
    non-read ops and padding lanes). Same semantics as the JAX package's
    branch-free transition; `op` is a Python int here, so the masks that a
    given op leaves empty are skipped instead of computed.

      read   gather payloads; access bit + ATC when armed; COLD-hit
             promotion count; fault-in HOST superblocks
      write  scatter payloads to live ids (a store is also an access)
      alloc  claim a slot per dead id — NEW first, spilling COLD then HOT
             off the free rings; live ids are rewritten in place; a
             duplicated id claims ONE slot
      free   release live ids: slot pushed on its region's ring,
             occupancy -1; duplicates in one batch free once"""
    is_read, is_write = op == OP_READ, op == OP_WRITE
    is_alloc, is_free = op == OP_ALLOC, op == OP_FREE
    n_slots = cfg.n_slots

    valid = obj_ids >= 0
    ids = torch.clamp(obj_ids, min=0).long()
    # XLA gathers clamp out-of-range indices; torch would raise
    words = state["table"][ids.clamp(max=cfg.max_objects - 1)]
    live = ot.is_live(words) & valid
    first = fl.first_occurrence(obj_ids)
    slots = ot.slot_of(words)
    none = torch.zeros_like(valid)

    free_q = state["free_q"]
    free_head, free_count = state["free_head"], state["free_count"]
    f_mask = live & first if is_free else none
    if is_free:
        free_q, free_head, free_count = fl.push(
            cfg, free_q, free_head, free_count, slots, f_mask)

    ok_new = none
    a_do = none
    a_slot = slots
    if is_alloc:
        need = (~live) & valid & first
        new_slot, ok_new, free_head, free_count = fl.pop(
            cfg, free_q, free_head, free_count, need)
        a_do = live | ok_new
        a_slot = torch.where(ok_new, new_slot, slots)

    data = state["data"]
    if is_write or is_alloc:
        # dead/padding lanes route to the scratch row and write ZEROS
        d_mask = live if is_write else a_do
        d_slot = a_slot if is_alloc else slots
        data.index_put_(
            (torch.where(d_mask, d_slot, n_slots).long(),),
            torch.where(d_mask[:, None], values.to(data.dtype), 0))

    if is_read:
        vals = torch.where(live[:, None], data[slots.long()], 0)
    else:
        vals = torch.zeros((obj_ids.shape[0], cfg.slot_words),
                           dtype=data.dtype, device=data.device)

    rw_live = live if (is_read or is_write) else none
    tbl = state["table"]
    if is_read or is_write:
        tbl = ot.record_access(tbl, torch.where(rw_live, obj_ids, -1),
                               armed=state["armed"])
    owner, sb_occ, slot_ref = (state["slot_owner"], state["sb_occ"],
                               state["slot_ref"])
    if is_alloc:
        alloc_words = torch.where(
            ok_new, ot.pack(a_slot, fl.region_of_slot(cfg, a_slot), access=1),
            words | (ot.ACCESS_MASK << ot.ACCESS_SHIFT))
        a_dst = torch.where(a_do, ids, cfg.max_objects)
        hit_a = ot.hit_mask(cfg.max_objects, a_dst)
        word_a = ot.set_drop(torch.zeros_like(tbl), a_dst, alloc_words)
        tbl = torch.where(hit_a, word_a, tbl)
        owner = ot.set_drop(owner, torch.where(ok_new, a_slot, n_slots).long(),
                            torch.where(ok_new, obj_ids, -1))
        sb_occ = ot.add_drop(
            sb_occ, torch.where(ok_new, a_slot // cfg.sb_slots,
                                cfg.n_sbs).long(), 1)
    if is_free:
        hit_f = ot.hit_mask(cfg.max_objects, torch.where(f_mask, ids,
                                                         cfg.max_objects))
        tbl = torch.where(hit_f, ot.FREE_WORD, tbl)
        owner = ot.set_drop(owner, torch.where(f_mask, slots, n_slots).long(),
                            -1)
        sb_occ = ot.add_drop(
            sb_occ, torch.where(f_mask, slots // cfg.sb_slots,
                                cfg.n_sbs).long(), -1)
    touch = rw_live | a_do
    slot_ref = ot.set_drop(
        slot_ref, torch.where(touch, a_slot if is_alloc else slots,
                              n_slots).long(), True)
    if is_free:
        slot_ref = ot.set_drop(
            slot_ref, torch.where(f_mask, slots, n_slots).long(), False)

    sb_tier, sb_evict = state["sb_tier"], state["sb_evict"]
    n_faults = torch.zeros((), dtype=_I32, device=data.device)
    if is_read:
        sbs = (slots // cfg.sb_slots).long()
        on_host = live & (sb_tier[sbs.clamp(max=cfg.n_sbs - 1)] == HOST)
        fault_mask = ot.hit_mask(cfg.n_sbs, torch.where(on_host, sbs,
                                                        cfg.n_sbs))
        n_faults = fault_mask.sum(dtype=_I32)
        sb_tier = torch.where(fault_mask, HBM, sb_tier)
        sb_evict = torch.where(fault_mask, NORMAL, sb_evict)

    accs = rw_live.sum(dtype=_I32) + a_do.sum(dtype=_I32)
    promos = (rw_live & (ot.heap_of(words) == ot.COLD)).sum(dtype=_I32)
    state = dict(state, data=data, table=tbl, slot_owner=owner,
                 free_q=free_q, free_head=free_head, free_count=free_count,
                 sb_occ=sb_occ, slot_ref=slot_ref, sb_tier=sb_tier,
                 sb_evict=sb_evict,
                 win_accesses=state["win_accesses"] + accs,
                 win_promos=state["win_promos"] + promos,
                 win_faults=state["win_faults"] + n_faults,
                 total_faults=state["total_faults"] + n_faults)
    return state, vals


def _zero_values(cfg: PoolConfig, obj_ids: torch.Tensor) -> torch.Tensor:
    return torch.zeros((obj_ids.shape[0], cfg.slot_words),
                       dtype=torch_dtype(cfg.dtype), device=obj_ids.device)


def alloc(cfg, state, obj_ids, values) -> Dict:
    """Allocate `obj_ids` [k] with payloads `values` [k, W] (see apply_op)."""
    return apply_op(cfg, state, OP_ALLOC, obj_ids, values)[0]


def read(cfg, state, obj_ids) -> Tuple[torch.Tensor, Dict]:
    """Gather object payloads for `obj_ids` [k] (-1 entries return zeros).
    Returns (vals [k, W], state): the JAX order, the reverse of
    `apply_op`'s."""
    state, vals = apply_op(cfg, state, OP_READ, obj_ids,
                           _zero_values(cfg, obj_ids))
    return vals, state


def write(cfg, state, obj_ids, values) -> Dict:
    """Scatter payloads to live objects (a store is also an access)."""
    return apply_op(cfg, state, OP_WRITE, obj_ids, values)[0]


def free(cfg, state, obj_ids) -> Dict:
    """Release objects: their slots return to their regions' rings."""
    return apply_op(cfg, state, OP_FREE, obj_ids,
                    _zero_values(cfg, obj_ids))[0]


# ---------------------------------------------------------------------------
# Superblock summaries (the only view backends get)
# ---------------------------------------------------------------------------
def sb_occupancy(cfg: PoolConfig, state: Dict) -> torch.Tensor:
    """Per-superblock live-slot count [n_sbs]: the carried counters."""
    return state["sb_occ"]


def recompute_sb_occupancy(cfg: PoolConfig,
                           slot_owner: torch.Tensor) -> torch.Tensor:
    """Occupancy [n_sbs] int32 counted from the slot-owner array: the
    consistency oracle of the carried counters, and the rebuild of passes
    that rewrite whole regions (`collector.compact_heap`)."""
    return (slot_owner >= 0).view(cfg.n_sbs, cfg.sb_slots).sum(
        dim=1, dtype=_I32)


def superblock_stats(cfg: PoolConfig, state: Dict) -> Dict[str, torch.Tensor]:
    ref = state["slot_ref"].view(cfg.n_sbs, cfg.sb_slots).any(dim=1)
    return {"occupancy": sb_occupancy(cfg, state), "referenced": ref,
            "region": cfg.sb_region_ids(ref.device),
            "tier": state["sb_tier"], "evict": state["sb_evict"]}


def rss_bytes(cfg: PoolConfig, state: Dict) -> torch.Tensor:
    """Resident (HBM-tier) bytes: occupied superblocks still in HBM."""
    resident = (sb_occupancy(cfg, state) > 0) & (state["sb_tier"] == HBM)
    return resident.sum().to(torch.float32) * float(cfg.sb_bytes)


def host_bytes(cfg: PoolConfig, state: Dict) -> torch.Tensor:
    out = (sb_occupancy(cfg, state) > 0) & (state["sb_tier"] == HOST)
    return out.sum().to(torch.float32) * float(cfg.sb_bytes)
