"""Carried free-slot queues — the pool's O(K)-per-op allocator state (port
of `repro/core/freelist.py`).

    free_q     int32 [n_slots]  three per-region circular rings; region r's
                                ring lives in free_q[lo_r:hi_r]
    free_head  int32 [3]        ring head per region (NEW=0, HOT=1, COLD=2)
    free_count int32 [3]        free slots available per region

`pop` takes from a ring's head (the lowest free slots as of the last
restock), `push` appends freed slots at the tail, and once per window the
collector's `restock` rebuilds every ring in ascending slot order from
`slot_owner`. Allocation spills NEW -> COLD -> HOT. Every sort is stable,
as `jnp.argsort`/`jnp.sort` are, so the rings match the JAX package's bit
for bit.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core import object_table as ot

_REGIONS = (ot.NEW, ot.HOT, ot.COLD)
_SPILL = (ot.NEW, ot.COLD, ot.HOT)
_I32 = torch.int32


@functools.lru_cache(maxsize=64)
def _spans(cfg, order, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cap) int32 [3] tensors for the given region order (cached: a
    tensor built from a Python list is a host-to-device copy)."""
    lo = torch.tensor([cfg.region(r)[0] for r in order], dtype=_I32,
                      device=device)
    cap = torch.tensor([cfg.region(r)[1] - cfg.region(r)[0] for r in order],
                       dtype=_I32, device=device)
    return lo, cap


@functools.lru_cache(maxsize=16)
def _spill_index(device) -> torch.Tensor:
    return torch.tensor(_SPILL, dtype=torch.long, device=device)


def region_of_slot(cfg, slot: torch.Tensor) -> torch.Tensor:
    """Heap-region id of a physical slot (static boundaries), int32."""
    new_end = cfg.region(ot.NEW)[1]
    hot_end = cfg.region(ot.HOT)[1]
    return torch.where(slot < new_end, ot.NEW,
                       torch.where(slot < hot_end, ot.HOT, ot.COLD)
                       ).to(_I32)


def first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """[k] bool: True where the entry is the first occurrence of its id
    (stable argsort + adjacent compare + inverse scatter)."""
    order = torch.argsort(ids, stable=True)
    s = ids[order]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                      s[1:] != s[:-1]])
    out = torch.zeros_like(head)
    out[order] = head
    return out


def seed(cfg, device=None):
    """Fresh rings for an empty pool: every region's ring is its own slot
    span in ascending order, all free."""
    free_q = torch.arange(cfg.n_slots, dtype=_I32, device=device)
    head = torch.zeros(3, dtype=_I32, device=device)
    _, cap = _spans(cfg, _REGIONS, device)
    return free_q, head, cap


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def pop(cfg, free_q, head, count, need):
    """Pop one free slot per True entry of `need` [k], NEW spilling to COLD
    then HOT. Returns (slots [k], ok [k], head', count')."""
    dev = free_q.device
    lo, cap = _spans(cfg, _SPILL, dev)
    sidx = _spill_index(dev)
    cnt = count[sidx]
    hd = head[sidx]
    cum = torch.cat([torch.zeros(1, dtype=_I32, device=dev), _cumsum(cnt)])

    rank = _cumsum(need) - 1
    ok = need & (rank < cum[3])
    sel = ((rank >= cum[1]).to(torch.long)
           + (rank >= cum[2]).to(torch.long))
    pos = (hd[sel] + rank - cum[sel]) % cap[sel]
    slots = free_q[torch.clamp(lo[sel] + pos, 0, cfg.n_slots - 1).long()]

    total = need.to(_I32).sum(dtype=_I32)
    take = torch.minimum(torch.clamp(total - cum[:3], min=0), cnt)
    head = head.clone()
    count = count.clone()
    head[sidx] = (hd + take) % cap
    count[sidx] = cnt - take
    return slots, ok, head, count


def pop_region(cfg, free_q, head, count, region: int, need):
    """Pop one free slot per True entry of `need` [m] from ONE region's ring
    (no spill). Returns (slots, ok, head', count')."""
    lo_, hi_ = cfg.region(region)
    cap_ = hi_ - lo_
    rank = _cumsum(need) - 1
    ok = need & (rank < count[region])
    pos = (head[region] + rank) % cap_
    slots = free_q[torch.clamp(lo_ + pos, 0, cfg.n_slots - 1).long()]
    take = torch.minimum(need.to(_I32).sum(dtype=_I32), count[region])
    head = head.clone()
    count = count.clone()
    head[region] = (head[region] + take) % cap_
    count[region] = count[region] - take
    return slots, ok, head, count


def push(cfg, free_q, head, count, slots, mask):
    """Append `slots[mask]` to their regions' ring tails."""
    lo, cap = _spans(cfg, _REGIONS, free_q.device)
    reg = region_of_slot(cfg, slots).long()
    rank = torch.zeros_like(slots)
    add = []
    for r in range(3):
        m = mask & (reg == r)
        rank = torch.where(m, _cumsum(m) - 1, rank)
        add.append(m.to(_I32).sum(dtype=_I32))
    pos = (head[reg] + count[reg] + rank) % cap[reg]
    idx = torch.where(mask, lo[reg] + pos, cfg.n_slots)
    free_q = ot.set_drop(free_q, idx.long(), slots)
    return free_q, head, count + torch.stack(add)


def restock(cfg, free_q, slot_owner):
    """Rebuild every ring from `slot_owner` in ascending slot order; dead
    ring entries are zeroed so the carried state is a pure function of the
    owner array."""
    dev = free_q.device
    free_q = free_q.clone()
    counts = []
    for r in _REGIONS:
        lo_, hi_ = cfg.region(r)
        seg_free = slot_owner[lo_:hi_] == -1
        n_free = seg_free.to(_I32).sum(dtype=_I32)
        keys = torch.where(seg_free,
                           torch.arange(lo_, hi_, dtype=_I32, device=dev),
                           torch.iinfo(torch.int32).max)
        ring = torch.sort(keys).values
        ring = torch.where(torch.arange(hi_ - lo_, device=dev) < n_free,
                           ring, 0)
        free_q[lo_:hi_] = ring
        counts.append(n_free)
    return (free_q, torch.zeros(3, dtype=_I32, device=dev),
            torch.stack(counts))
