"""Tiered embedding table — HADES applied to vocab rows (port of
`repro/models/embedding.py`).

Token frequency is zipfian (a few thousand rows absorb most lookups), so
the embedding table is the canonical hotness-fragmented object array: hot
rows scattered across a 100k-row table pin the whole table in device
memory. The tiered table keeps a dense HOT replica of the top rows and
leaves the full table in the host tier; a two-level remap (the object
table of this pool) routes lookups.

Functional state, every tensor on the table's device:
  full   [V, D]  — authoritative table
  hot    [Hn, D] — dense replica of the currently-hot rows
  hot_ids [Hn] int32 — the rows the replica holds
  remap  [V] int32 — row -> hot index, or -1 (cold: read through)
  counts [V] fp32 — EMA access counts (the access-bit analog)
  win_lookups, win_cold_hits — int32 0-d window counters

`lookup` gathers hot rows from the replica and cold rows from the full
table (a cold hit is a promotion event — the MIAD signal). `collect`
re-elects the top-Hn rows and rebuilds the replica (the Object
Collector's migration, at row granularity). Neither syncs with the host.
Every function returns new tensors and leaves its input state as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TieredEmbeddingConfig:
    vocab_size: int
    d_model: int
    hot_rows: int
    ema: float = 0.9


def _remap(cfg: TieredEmbeddingConfig, hot_ids: torch.Tensor
           ) -> torch.Tensor:
    remap = torch.full((cfg.vocab_size,), -1, dtype=torch.int32,
                       device=hot_ids.device)
    remap[hot_ids.long()] = torch.arange(cfg.hot_rows, dtype=torch.int32,
                                         device=hot_ids.device)
    return remap


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def init(cfg: TieredEmbeddingConfig, table: torch.Tensor) -> Dict:
    """Wrap an existing [V, D] table. Initial hot set: first hot_rows."""
    dev = table.device
    hot_ids = torch.arange(cfg.hot_rows, dtype=torch.int32, device=dev)
    return {
        "full": table,
        "hot": table[hot_ids.long()],
        "hot_ids": hot_ids,
        "remap": _remap(cfg, hot_ids),
        "counts": torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                              device=dev),
        "win_lookups": _zero(dev),
        "win_cold_hits": _zero(dev),
    }


def lookup(cfg: TieredEmbeddingConfig, state: Dict, tokens: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict]:
    """tokens: [...] int -> (embeddings [..., D], state with counters).
    Hot rows come from the dense replica; cold rows read through to the
    full table — each cold hit is a promotion event."""
    tokens = tokens.long()
    hot_idx = state["remap"][tokens]                   # [...], -1 = cold
    is_hot = hot_idx >= 0
    from_hot = state["hot"][hot_idx.clamp_min(0).long()]
    from_full = state["full"][tokens]
    out = torch.where(is_hot[..., None], from_hot, from_full)
    # every addend is 1.0: a row's count goes up by one at a time in any
    # order, so the sum is the same on every device and as JAX's scatter
    flat = tokens.reshape(-1)
    counts = state["counts"].index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=flat.device))
    return out, dict(
        state, counts=counts,
        win_lookups=state["win_lookups"] + tokens.numel(),
        win_cold_hits=state["win_cold_hits"] +
        (~is_hot).sum(dtype=torch.int32))


def collect(cfg: TieredEmbeddingConfig, state: Dict) -> Tuple[Dict, Dict]:
    """Re-elect the hot set from EMA counts and rebuild the dense replica
    (row migration). Returns (state, report)."""
    counts = state["counts"]
    # jax.lax.top_k's order: descending, ties to the lower row (a stable
    # sort; torch.topk orders ties otherwise)
    hot = torch.sort(counts, descending=True, stable=True)[1][:cfg.hot_rows]
    hot_ids = hot.to(torch.int32)
    cold_rate = state["win_cold_hits"].float() / \
        state["win_lookups"].float().clamp_min(1.0)
    # the coverage's sums in float64: the same value on every device
    # (a float32 sum's rounding depends on its order)
    c64 = counts.double()
    coverage = (c64[hot].sum() / c64.sum().clamp_min(1.0)).float()
    report = {"cold_hit_rate": cold_rate, "hot_coverage": coverage}
    new_state = dict(
        state, hot=state["full"][hot], hot_ids=hot_ids,
        remap=_remap(cfg, hot_ids), counts=counts * cfg.ema,
        win_lookups=_zero(counts.device),
        win_cold_hits=_zero(counts.device))
    return new_state, report


def write_rows(state: Dict, rows: torch.Tensor, values: torch.Tensor
               ) -> Dict:
    """Training update path: write the full table; refresh any hot
    replicas. Rows should be distinct: on the card, which of two writes
    to one row lands is not defined. Selecting the hot rows syncs with
    the host."""
    rows = rows.long()
    full = state["full"].index_put((rows,), values)
    hot_idx = state["remap"][rows]
    is_hot = hot_idx >= 0
    hot = state["hot"].index_put((hot_idx[is_hot].long(),), values[is_hot])
    return dict(state, full=full, hot=hot)


def hbm_bytes(cfg: TieredEmbeddingConfig, dtype=torch.bfloat16) -> int:
    return cfg.hot_rows * cfg.d_model * dtype.itemsize


def total_bytes(cfg: TieredEmbeddingConfig, dtype=torch.bfloat16) -> int:
    return cfg.vocab_size * cfg.d_model * dtype.itemsize
