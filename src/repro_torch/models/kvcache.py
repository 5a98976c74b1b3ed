"""Paged KV cache managed by the HADES frontend (port of
`repro/models/kvcache.py`).

Decode-time KV blocks are objects in a HadesPool: each block is
`block_tokens` of K+V for one layer of one sequence. Block tables hold
LOGICAL object ids, resolved to physical slots through the object table
right before attention — which is what makes migration transparent to the
serving loop. Attention reads the pool through the `paged_attention`
kernel, whose fused access bits become object-table access bits.

Logical object id = ((layer * batch) + seq) * max_blocks + block_idx.

The pool's `data` is written IN PLACE (the token append and the
collector's migration); the JAX package donates the carry for the same
reason. Lanes carry a lifecycle (`active` [B] bool + per-lane `pos`):
inactive lanes never append, allocate or record accesses, and their
attention output is zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.core import backend as be
from repro_torch.core import collector as col
from repro_torch.core import engine as eng
from repro_torch.core import object_table as ot
from repro_torch.core import pool as pl
from repro_torch.kernels import ops as kops

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    batch: int
    max_blocks: int          # per (layer, sequence)
    block_tokens: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"
    sb_slots: int = 16       # superblock granularity (blocks per madvise)
    slack: float = 1.5

    @property
    def max_objects(self) -> int:
        return self.num_layers * self.batch * self.max_blocks

    @property
    def slot_words(self) -> int:
        return 2 * self.block_tokens * self.num_kv_heads * self.head_dim

    def obj_id(self, layer, seq, block):
        return (layer * self.batch + seq) * self.max_blocks + block

    def pool_config(self) -> pl.PoolConfig:
        return pl.make_config(
            self.max_objects, self.slot_words, sb_slots=self.sb_slots,
            page_slots=max(self.sb_slots // 4, 1), slack=self.slack,
            dtype=self.dtype)


def init(cfg: KVCacheConfig, backend: Optional[be.Backend] = None,
         active: bool = True, device=None) -> Dict:
    """Fresh serving state. `active=False` starts every lane empty, for a
    continuous-batching driver that admits lanes via `admit_lanes`."""
    pool = pl.init(cfg.pool_config(), device)
    if backend is not None:
        pool = dict(pool, bstate=backend.init(cfg.pool_config(), device))
    return {
        "pool": pool,
        "block_tables": torch.full(
            (cfg.num_layers, cfg.batch, cfg.max_blocks), -1, dtype=_I32,
            device=device),
        "pos": torch.zeros(cfg.batch, dtype=_I32, device=device),
        "active": torch.full((cfg.batch,), bool(active), dtype=torch.bool,
                             device=device),
    }


def append(cfg: KVCacheConfig, state: Dict, k: torch.Tensor,
           v: torch.Tensor) -> Dict:
    """k/v: [L, B, KV, D] (one new token per sequence): `append_layer` for
    every layer, then the step's pos advance. Tokens past cfg.max_blocks
    capacity are dropped."""
    for li in range(cfg.num_layers):
        state = append_layer(cfg, state, li, k[li], v[li])
    return advance_pos(state)


def append_layer(cfg: KVCacheConfig, state: Dict, layer: int,
                 k: torch.Tensor, v: torch.Tensor) -> Dict:
    """k/v: [B, KV, D] — ONE layer's k/v for the current token. Allocates a
    block at each active lane's block boundary, then writes the token into
    the pool in place. Does NOT advance `pos` (the caller calls
    `advance_pos` once per step). Tokens past cfg.max_blocks capacity, and
    inactive lanes, are dropped: their writes go to the scratch row as
    zeros, never clamped into a live object's slot."""
    pcfg = cfg.pool_config()
    dev = k.device
    pos = state["pos"]
    blk = pos // cfg.block_tokens
    off = pos % cfg.block_tokens
    fits = (blk < cfg.max_blocks) & state["active"]
    b_idx = torch.arange(cfg.batch, device=dev)
    obj = ((layer * cfg.batch + b_idx) * cfg.max_blocks + blk).to(_I32)

    need = (off == 0) & fits
    pool = state["pool"]
    zeros = torch.zeros((cfg.batch, pcfg.slot_words), dtype=pool["data"].dtype,
                        device=dev)
    pool = pl.alloc(pcfg, pool, torch.where(need, obj, -1), zeros)

    # block_tables[layer, b, blk] = obj where a block was allocated; an
    # overflowing blk (>= max_blocks) goes to a sink column and is dropped
    tables = state["block_tables"].clone()
    row = tables[layer]                                  # [B, MB] view
    blk_safe = torch.clamp(blk, max=cfg.max_blocks - 1).long()
    keep = torch.where(need, obj, row[b_idx, blk_safe])
    row_ext = torch.cat([row, row.new_zeros((cfg.batch, 1))], dim=1)
    row_ext[b_idx, torch.clamp(blk, max=cfg.max_blocks).long()] = keep
    row.copy_(row_ext[:, :cfg.max_blocks])

    words = pool["table"][torch.clamp(obj, max=cfg.max_objects - 1).long()]
    slots = torch.where(fits, ot.slot_of(words), pcfg.n_slots).long()
    data = pool["data"].view(-1, 2, cfg.block_tokens, cfg.num_kv_heads,
                             cfg.head_dim)
    kv_tok = torch.stack([k, v], dim=1).to(data.dtype)   # [B, 2, KV, D]
    data[slots, :, off.long()] = torch.where(fits[:, None, None, None],
                                             kv_tok, 0)
    return dict(state, pool=pool, block_tables=tables)


def advance_pos(state: Dict) -> Dict:
    """One decode step consumed: pos += 1 on active lanes."""
    return dict(state, pos=state["pos"] + state["active"].to(_I32))


def free_lanes(cfg: KVCacheConfig, state: Dict, lanes: torch.Tensor) -> Dict:
    """Finish the masked lanes ([B] bool): free ALL their KV objects with ONE
    batched `pool.free` over every (layer, block) id the lane could own;
    reset their block tables to -1, pos to 0, and clear their active bit."""
    pcfg = cfg.pool_config()
    dev = lanes.device
    li = torch.arange(cfg.num_layers, dtype=_I32, device=dev)[:, None, None]
    bi = torch.arange(cfg.batch, dtype=_I32, device=dev)[None, :, None]
    ki = torch.arange(cfg.max_blocks, dtype=_I32, device=dev)[None, None, :]
    obj = (li * cfg.batch + bi) * cfg.max_blocks + ki
    ids = torch.where(lanes[None, :, None], obj, -1).reshape(-1)
    return dict(state,
                pool=pl.free(pcfg, state["pool"], ids),
                block_tables=torch.where(lanes[None, :, None], -1,
                                         state["block_tables"]),
                pos=torch.where(lanes, 0, state["pos"]),
                active=state["active"] & ~lanes)


def admit_lanes(state: Dict, lanes: torch.Tensor) -> Dict:
    """Activate the masked lanes for fresh sequences: pos 0, active set."""
    return dict(state, pos=torch.where(lanes, 0, state["pos"]),
                active=state["active"] | lanes)


def attend(cfg: KVCacheConfig, state: Dict, layer: int, q: torch.Tensor,
           *, seq_lens: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Dict]:
    """q: [B, H, D] -> (out [B, H, D], state with the access recorded).
    `seq_lens` defaults to state["pos"]; the per-layer flow (pos still AT
    the new token) passes pos + 1 so the token attends to itself."""
    pcfg = cfg.pool_config()
    pool = state["pool"]
    tbl = state["block_tables"][layer]               # [B, MB] logical ids
    live = tbl >= 0
    words = pool["table"][torch.clamp(tbl, 0, cfg.max_objects - 1).long()]
    slots = torch.where(live, ot.slot_of(words), -1)
    lens = state["pos"] if seq_lens is None else seq_lens
    active = state["active"]
    lens = torch.where(active, lens, 0).to(_I32)
    pages = pool["data"].view(-1, 2, cfg.block_tokens, cfg.num_kv_heads,
                              cfg.head_dim)
    spans.stamp("kv.append")
    out, touched = kops.paged_attention(q.contiguous(), pages[:, 0],
                                        pages[:, 1], slots.contiguous(), lens)
    spans.stamp("attention")
    # inactive lanes really do return ZEROS
    out = torch.where(active[:, None, None], out, 0)
    touched_ids = torch.where(touched & live & active[:, None], tbl,
                              -1).reshape(-1)
    pool = _record_touched(pcfg, pool, touched_ids)
    spans.stamp("kv.record")
    return out, dict(state, pool=pool)


def _record_touched(pcfg: pl.PoolConfig, pool: Dict,
                    obj_ids: torch.Tensor) -> Dict:
    """pool.read's accounting without the data gather (the kernel already
    read the blocks): access bits, ATC when armed, promo/fault counters."""
    valid = obj_ids >= 0
    words = pool["table"][torch.clamp(obj_ids, 0,
                                      pcfg.max_objects - 1).long()]
    live = ot.is_live(words) & valid
    tbl = ot.record_access(pool["table"], torch.where(live, obj_ids, -1),
                           armed=pool["armed"])
    slots = ot.slot_of(words)
    slot_ref = ot.set_drop(pool["slot_ref"],
                           torch.where(live, slots, pcfg.n_slots).long(),
                           True)
    sbs = (slots // pcfg.sb_slots).long()
    on_host = live & (pool["sb_tier"][sbs.clamp(max=pcfg.n_sbs - 1)]
                      == pl.HOST)
    fault_mask = ot.hit_mask(pcfg.n_sbs, torch.where(on_host, sbs,
                                                     pcfg.n_sbs))
    n_faults = fault_mask.sum(dtype=_I32)
    promos = (live & (ot.heap_of(words) == ot.COLD)).sum(dtype=_I32)
    return dict(
        pool, table=tbl, slot_ref=slot_ref,
        sb_tier=torch.where(fault_mask, pl.HBM, pool["sb_tier"]),
        sb_evict=torch.where(fault_mask, pl.NORMAL, pool["sb_evict"]),
        win_accesses=pool["win_accesses"] + live.sum(dtype=_I32),
        win_promos=pool["win_promos"] + promos,
        win_faults=pool["win_faults"] + n_faults,
        total_faults=pool["total_faults"] + n_faults)


def collect(cfg: KVCacheConfig, state: Dict,
            col_cfg: Optional[col.CollectorConfig] = None
            ) -> Tuple[Dict, Dict]:
    """One Object Collector pass over the KV pool (no backend)."""
    pool, report = col.collect(cfg.pool_config(),
                               col_cfg or col.CollectorConfig(),
                               state["pool"])
    return dict(state, pool=pool), report


def collect_and_backend(cfg: KVCacheConfig, col_cfg: col.CollectorConfig,
                        backend: be.Backend, state: Dict
                        ) -> Tuple[Dict, Dict]:
    """Collector + backend over the KV pool as one transition."""
    pool, report = eng.collect_and_backend(cfg.pool_config(), col_cfg,
                                           backend, state["pool"])
    return dict(state, pool=pool), report


def arm(state: Dict) -> Dict:
    return dict(state, pool=col.arm(state["pool"]))


def kv_bytes(cfg: KVCacheConfig) -> int:
    return cfg.max_objects * cfg.slot_words * \
        pl.torch_dtype(cfg.dtype).itemsize
